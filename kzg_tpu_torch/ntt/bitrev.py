"""Reverse-bit-order permutation (reference: reverse_bit_order.go:55-101)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bit_reversal_indices(n: int) -> np.ndarray:
    """int32 (n,) p with p[i] = i bit-reversed over log2(n) bits."""
    if n & (n - 1) != 0 or n == 0:
        raise ValueError("length must be a power of two")
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out.astype(np.int32)


def reverse_bits_limited(length: int, value: int) -> int:
    """reference: reverseBitsLimited (reverse_bit_order.go:81-84)."""
    bits = max(length.bit_length() - 1, 0)
    out = 0
    for b in range(bits):
        out |= ((value >> b) & 1) << (bits - 1 - b)
    return out


def brp_permute(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Bit-reversal permutation along `axis`: viewing the axis as log2(n)
    binary dimensions and reversing their order is the permutation."""
    axis = axis % x.dim()
    n = x.shape[axis]
    if n & (n - 1) != 0:
        raise ValueError("length must be a power of two")
    if n <= 2:
        return x
    bits = n.bit_length() - 1
    lead = tuple(x.shape[:axis])
    y = x.reshape(lead + (2,) * bits + tuple(x.shape[axis + 1:]))
    la = len(lead)
    perm = (tuple(range(la))
            + tuple(la + bits - 1 - i for i in range(bits))
            + tuple(range(la + bits, y.dim())))
    return y.permute(perm).reshape(x.shape)



def reverse_bit_order(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """A tensor in reverse-bit order along `axis` (-2 for an Fr or Fp
    batch, whose last axis holds the words; apply per coordinate to a
    point batch)."""
    return brp_permute(x, axis=axis)
