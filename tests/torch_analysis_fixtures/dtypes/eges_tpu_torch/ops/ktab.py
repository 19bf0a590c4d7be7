"""Seeded dtype-promotion leaks in device code."""

import numpy as np
import torch

SQUEEZE = torch.tensor([0, 25, 1, 26])       # firing: literal, no dtype
SCRATCH = torch.zeros((8, 8))                # firing: dtype-less ctor
WIDE = torch.ones(3, dtype=float)            # firing: float64 request


def lane_index(i):
    return torch.full((2, 2), i, dtype=torch.float64)  # firing: float64


# -- clean twins ----------------------------------------------------------

SQUEEZE_OK = torch.tensor([0, 25, 1, 26], dtype=torch.int32)
SCRATCH_OK = torch.zeros((8, 8), dtype=torch.int32)
CARRIER = torch.zeros((8, 16), dtype=torch.int64)  # clean: the CPU carrier
HOST_SIDE = np.zeros((8, 8))                 # numpy stays host-typed
MASK = torch.ones(4)  # analysis: allow-dtype-promotion(fixture: a mask)


def reupload(existing):
    return torch.as_tensor(existing)         # clean: keeps source dtype
