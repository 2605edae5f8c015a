"""The BLS12-381 scalar field Fr as batched 32-bit words.

An Fr batch is a torch.int32 tensor (..., 8) in Montgomery form
(R = 2^256), always fully reduced. `mul` runs on kernel K1; add, sub and
neg on `fr_add_sub`, `pow_static` and `inv` on `fr_pow` (the whole ladder
in one launch), `batch_inv` on `fr_batch_inv`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs
from .kernels import (
    FR,
    fr_add_sub,
    fr_batch_inv,
    fr_pow,
    fr_signed_windows,
    mont_mul,
)

SPEC = FR
N_WORDS = SPEC.n_words


def add(a, b):
    return fr_add_sub(SPEC, "add", a, b)


def sub(a, b):
    return fr_add_sub(SPEC, "sub", a, b)


def neg(a):
    return fr_add_sub(SPEC, "neg", a)


def mul(a, b):
    return mont_mul(SPEC, a, b)


def pow_static(a, e: int):
    return fr_pow(SPEC, a, e)


def inv(a):
    """Fermat inverse a^(r-2), lane-parallel; 0 -> 0."""
    return pow_static(a, SPEC.modulus - 2)


def batch_inv(a):
    """Montgomery-trick batch inversion over all leading axes; 0 -> 0."""
    return fr_batch_inv(SPEC, a)


def div(a, b):
    return mul(a, inv(b))


eq = limbs.eq
is_zero = limbs.is_zero
select = limbs.select


def is_one(a):
    return eq(a, SPEC.words([SPEC.one_mont], a.device)[0])


def zeros(shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (N_WORDS,), dtype=torch.int32,
                       device=device)


def from_mont(a) -> torch.Tensor:
    """Montgomery words -> canonical words (REDC by the integer 1, K1)."""
    one = SPEC.words([1], a.device)[0]
    return mul(a, one)


def scalar_windows_signed(a_mont) -> torch.Tensor:
    """Signed 4-bit windows of Montgomery-form scalars: int32 (..., 64)
    LSB-first digits s with sum_j s_j 16^j == a, s_j in [-8, 7] for
    j < 63 and s_63 in [0, 8] (kzg_tpu/field/fr.py:109-130): one launch
    of fr_signed_windows, which reduces the words itself."""
    return fr_signed_windows(a_mont)


# ---- host conversions ----
def from_int(values, device="cuda") -> torch.Tensor:
    """Python int (or nested lists) -> Montgomery words, reduced mod r."""
    return SPEC.encode(values, device)


def to_int(t) -> np.ndarray:
    """Montgomery words -> object array of canonical Python ints."""
    return SPEC.decode(t)
