"""launch-purity true negatives: a cast of a shape, an lru_cached table
(it is made once, on the host), and a facade's resolve method, whose
job is to wait for the card."""

import functools

import numpy as np

from eges_tpu_torch.ops.kernels import mul_scalar_f32


@functools.lru_cache(maxsize=1)
def _table():
    return np.asarray([1, 2, 3]).tolist()  # host table: exempt via cache


def kernel(x):
    n = int(x.shape[0])  # static: a shape, not a value on the card
    return mul_scalar_f32(x, n + _table()[0])


class CleanVerifier:
    def verify(self, x):
        return kernel(x).cpu().numpy()  # resolve boundary: exempt
