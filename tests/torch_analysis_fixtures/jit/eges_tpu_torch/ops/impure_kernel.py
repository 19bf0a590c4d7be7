"""Seeded launch-purity true positives: a host clock read that a kernel
launch then computes with, and a print and a device wait around a
launch."""

import time

from eges_tpu_torch.ops.kernels import mul_scalar_f32


def run(x):
    t0 = time.time()  # host clock read at every launch
    return mul_scalar_f32(x, t0)


def noisy_sum(x):
    print("launching")  # host output at every launch
    return mul_scalar_f32(x, 2.0).sum().item()  # waits for the card
