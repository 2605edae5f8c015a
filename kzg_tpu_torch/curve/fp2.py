"""Fp2 = Fp[u]/(u^2 + 1) as batched word tensors (kzg_tpu/curve/fp2.py).

An Fp2 batch is an int32 tensor (..., 2, 12): the components (c0, c1),
then the Fp words in Montgomery form. The ops are `fp`'s (every leading
axis is batch), so G2's generic curve arithmetic runs on them: a product
is one K1 launch of three stacked Fp products (Karatsuba), a sum one
`fr_add_sub` launch over both components.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fp


def make(c0, c1):
    return torch.stack(torch.broadcast_tensors(c0, c1), dim=-2)


def c0(a):
    return a[..., 0, :]


def c1(a):
    return a[..., 1, :]


def add(a, b):
    return fp.add(a, b)


def sub(a, b):
    return fp.sub(a, b)


def neg(a):
    return fp.neg(a)


def mul(a, b):
    """Karatsuba: the 3 Fp products in one stacked fp.mul."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = c0(a), c1(a), c0(b), c1(b)
    x = torch.stack((a0, a1, fp.add(a0, a1)))
    y = torch.stack((b0, b1, fp.add(b0, b1)))
    t0, t1, t2 = fp.mul(x, y).unbind(0)
    return make(fp.sub(t0, t1), fp.sub(t2, fp.add(t0, t1)))


def sqr(a):
    """(a0 + a1)(a0 - a1) and a0 a1 in one stacked fp.mul."""
    a0, a1 = c0(a), c1(a)
    x = torch.stack((fp.add(a0, a1), a0))
    y = torch.stack((fp.sub(a0, a1), a1))
    t0, t1 = fp.mul(x, y).unbind(0)
    return make(t0, fp.add(t1, t1))


def _norm_inv(a, inverse):
    a0, a1 = c0(a), c1(a)
    sq = fp.mul(torch.stack((a0, a1)), torch.stack((a0, a1)))
    ninv = inverse(fp.add(sq[0], sq[1]))
    prod = fp.mul(torch.stack((a0, a1)), torch.stack((ninv, ninv)))
    return make(prod[0], fp.neg(prod[1]))


def inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2): one Fermat inverse a lane; 0 -> 0."""
    return _norm_inv(a, fp.inv)


def batch_inv(a):
    """The norm inverse with fp.batch_inv doing the one Fp division."""
    return _norm_inv(a, fp.batch_inv)


def eq(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return (a == b).all(-1).all(-1)


def is_zero(a):
    return (a == 0).all(-1).all(-1)


def select(mask, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.where(mask[..., None, None], a, b)


def zero_like(a):
    return torch.zeros_like(a)


def one_like(a):
    one = fp.SPEC.words([fp.SPEC.one_mont, 0], a.device)
    return one.expand(a.shape).clone()


def from_int(pairs, device="cuda") -> torch.Tensor:
    """[(c0, c1), ...] Python ints (nested) -> Montgomery words."""
    return fp.from_int(np.asarray(pairs, dtype=object), device)


def to_int(a) -> np.ndarray:
    """-> object array (..., 2) of canonical ints."""
    return fp.to_int(a)
