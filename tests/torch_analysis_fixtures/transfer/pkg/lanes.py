"""Seeded transfer-hygiene defects: uploads in loops, unpinned commits on
a device-carrying class, staging reuse in the split-phase path."""

import threading

import numpy as np
import torch


def bucket_round(n, minimum):
    b = max(n, minimum)
    return 1 << (b - 1).bit_length()


class LoopyLaneVerifier:
    def __init__(self, device):
        self.device = device
        self._staging_buf = np.zeros((64, 65), np.uint8)
        self._staging_lock = threading.Lock()

    def ecrecover(self, sigs, hashes):
        outs = []
        for chunk in sigs:
            outs.append(torch.from_numpy(chunk).to(self.device))  # firing
        ds = torch.as_tensor(hashes)         # firing: left on the host
        return outs, ds

    def stage_recover(self, sigs):
        buf = self._staging_buf              # firing: single-buffer reuse
        buf[: len(sigs)] = sigs
        return torch.from_numpy(buf).to(self.device)

    def recover_addresses(self, sigs, hashes):
        # analysis: allow-transfer-hygiene(fixture: host rows on purpose)
        return torch.as_tensor(sigs)


class CleanDeviceLane:
    def __init__(self, device):
        self.device = device
        self._pipe = [np.zeros((64, 65), np.uint8) for _ in range(2)]
        self._pipe_toggle = 0

    def verify(self, sigs, hashes, pubs):
        return torch.as_tensor(sigs, device=self.device)  # clean: pinned

    def stage_recover(self, sigs):
        n = bucket_round(len(sigs), 16)
        i = self._pipe_toggle
        self._pipe_toggle = i ^ 1
        buf = self._pipe[i]                  # clean: double-buffer pair
        buf[:n] = sigs[:n]
        return torch.from_numpy(buf).to(self.device)  # clean: pinned
