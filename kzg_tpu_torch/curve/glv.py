"""Host-side GLV scalar split and signed-window recoding (the port's copy
of kzg_tpu/curve/glv.py).

For scalars known on the host (G1 FFT twiddles) k = k1 + lambda*k2 with
k2 = k // lambda and k1 = k mod lambda, both below 2^128, each recoded
into 33 signed 4-bit digits in [-7, 8]. Kernel K4 then runs a 33-window
ladder over B and phi(B) = (beta*x, y) instead of 64 windows over B.
"""

from __future__ import annotations

import functools

import numpy as np

from ..field.constants import FR_MODULUS

GLV_LAMBDA = 0xAC45A4010001A40200000000FFFFFFFF
# the cube root of unity mod p with phi(P) == lambda * P on the r-torsion
GLV_BETA = int(
    "0x1a0111ea397fe699ec02408663d4de85aa0d857d89759ad4897d29650fb85f9b"
    "409427eb4f49fffd8bfd00000000aaac", 16,
)

N_WINDOWS = 33  # ceil(128 / 4) + 1 carry digit from signed recoding


def signed_digits(k: int, n_windows: int = N_WINDOWS) -> list:
    """Non-negative int -> LSB-first signed 4-bit digits in [-7, 8] with
    sum d_j 16^j == k (a digit of 8 is kept, so the range leans to +8)."""
    out = []
    for _ in range(n_windows):
        d = k & 0xF
        if d > 8:
            d -= 16
            k += 16
        k >>= 4
        out.append(d)
    if k:
        raise ValueError("scalar too wide for the window count")
    return out


def decompose(k: int):
    """k in [0, r) -> (k1, k2) with k == k1 + lambda*k2, both < 2^128."""
    k %= FR_MODULUS
    k2, k1 = divmod(k, GLV_LAMBDA)
    return k1, k2


@functools.lru_cache(maxsize=None)
def _twiddle_digits_cached(scalars: tuple) -> tuple:
    d1 = np.empty((len(scalars), N_WINDOWS), dtype=np.int32)
    d2 = np.empty((len(scalars), N_WINDOWS), dtype=np.int32)
    for i, k in enumerate(scalars):
        k1, k2 = decompose(k)
        d1[i] = signed_digits(k1)
        d2[i] = signed_digits(k2)
    return d1, d2


def twiddle_digits(scalars) -> tuple:
    """Canonical host ints -> (d1, d2) int32 (N, 33) digit arrays."""
    return _twiddle_digits_cached(tuple(int(s) for s in scalars))
