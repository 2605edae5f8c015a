"""Reverse-bit-order permutation (reference: reverse_bit_order.go:55-101)."""

from __future__ import annotations

import torch


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

