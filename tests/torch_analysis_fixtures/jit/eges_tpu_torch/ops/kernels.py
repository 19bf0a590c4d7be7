"""A stub of the port's ops/kernels.py with the real file's shape, so the
fixture tree has a launch region of its own: a launch census, the one
``_launch``, and a wrapper whose ``_on_card`` branch takes its plain
version for a tensor on the CPU."""

import threading

import torch

LAUNCHES = {"mul_scalar_f32": 0}
_LAUNCHES_LOCK = threading.Lock()


def _launch(name, fn_name, *args):
    with _LAUNCHES_LOCK:
        # analysis: allow-launch-purity(fixture: the launch census)
        LAUNCHES[name] += 1


def _on_card(x):
    return x.device.type == "cuda"


def mul_scalar_f32_plain(x, s):
    rows = x.tolist()  # clean: the CPU path, exempt by its name
    return torch.tensor(rows, dtype=torch.float32) * s


def mul_scalar_f32(x, s):
    if not _on_card(x):
        return mul_scalar_f32_plain(x, s)
    out = torch.empty_like(x)
    _launch("mul_scalar_f32", "eg_mul_scalar_f32", x, s, x.numel(), out)
    return out
