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


def sqr(a):
    return mont_mul(SPEC, a, a)


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


def scalar_windows(a_mont) -> torch.Tensor:
    """Canonical 4-bit windows of Montgomery-form scalars: int32 (..., 64)
    with window i = (a >> 4i) & 0xF, LSB-first (kzg_tpu/field/fr.py:
    96-105)."""
    canon = from_mont(a_mont).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=canon.device)
    wins = (canon.unsqueeze(-1) >> shifts) & 0xF
    return wins.flatten(-2).to(torch.int32)


def scalar_bits(a_mont) -> torch.Tensor:
    """Canonical bits of Montgomery-form scalars: int32 (..., 256) with
    bit i = (a >> i) & 1 (kzg_tpu/field/fr.py:133-143)."""
    canon = from_mont(a_mont).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=canon.device)
    bits = (canon.unsqueeze(-1) >> shifts) & 1
    return bits.flatten(-2).to(torch.int32)


# ---- bytes (ValidFr, FrFrom32 / FrTo32; kzg_tpu/field/fr.py:175-236) ----
def valid_fr_bytes(b32: bytes) -> bool:
    """ValidFr on 32 little-endian bytes (reference:
    bls/bignum_all.go:12-35)."""
    if len(b32) != 32:
        raise ValueError("need exactly 32 bytes")
    return int.from_bytes(b32, "little") < SPEC.modulus


def from_bytes32_le(b32: bytes, device="cuda"):
    """FrFrom32: 32 little-endian bytes -> Fr words (8,), None if the
    value is not below r."""
    if not valid_fr_bytes(b32):
        return None
    return from_int(int.from_bytes(b32, "little"), device)


def to_bytes32_le(a) -> bytes:
    """FrTo32: one Fr element -> its canonical 32 little-endian bytes."""
    return int(to_int(a).reshape(-1)[0]).to_bytes(32, "little")


def valid_bytes32_batch(data) -> np.ndarray:
    """ValidFr over N 32-byte little-endian chunks -> bool (N,)."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8).reshape(-1, 32)
    mod = np.frombuffer(SPEC.modulus.to_bytes(32, "little"), np.uint8)
    diff = raw != mod
    # the most significant differing byte decides
    top = 31 - np.argmax(diff[:, ::-1], axis=1)
    rows = np.arange(raw.shape[0])
    return diff.any(axis=1) & (raw[rows, top] < mod[top])


def from_bytes32_batch(data, device="cuda"):
    """N x 32 little-endian bytes -> (Montgomery words (N, 8), valid bool
    (N,)): one K1 product by R^2 mod r. Rows that are not below r come
    out as some field element; the caller checks `valid` (the eth layer
    rejects a whole blob on any invalid element, eth/helpers.go:264-273)."""
    raw = np.frombuffer(bytes(data), dtype="<i4").reshape(-1, N_WORDS)
    words = torch.from_numpy(raw.copy()).to(device)
    r2 = SPEC.words([SPEC.r2], device)[0]
    return mul(words, r2), valid_bytes32_batch(data)


def to_bytes32_batch(a) -> np.ndarray:
    """Montgomery words (..., 8) -> uint8 (..., 32), the canonical values'
    little-endian bytes (one K1 product by 1)."""
    canon = from_mont(a).cpu().numpy().astype("<i4")
    return np.ascontiguousarray(canon).view(np.uint8).reshape(
        canon.shape[:-1] + (32,))


# ---- host conversions ----
def from_int(values, device="cuda") -> torch.Tensor:
    """Python int (or nested lists) -> Montgomery words, reduced mod r."""
    return SPEC.encode(values, device)


def to_int(t) -> np.ndarray:
    """Montgomery words -> object array of canonical Python ints."""
    return SPEC.decode(t)


def from_u64(values, device="cuda") -> torch.Tensor:
    """bls.AsFr parity: unsigned 64-bit ints -> Montgomery words."""
    return SPEC.encode(values, device)


def random(shape=(), generator: torch.Generator | None = None,
           device="cuda") -> torch.Tensor:
    """Uniform field elements, Montgomery words (*shape, 8): ten 32-bit
    draws of `generator` (a CPU torch.Generator; the default one if None)
    reduced mod r, a bias below 2^-60."""
    count = int(np.prod(shape)) if shape else 1
    draws = torch.randint(0, 1 << 32, (count, 10), generator=generator,
                          dtype=torch.int64).tolist()
    vals = [sum(w << (32 * i) for i, w in enumerate(row)) % SPEC.modulus
            for row in draws]
    return from_int(np.asarray(vals, dtype=object).reshape(shape), device)
