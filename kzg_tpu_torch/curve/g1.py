"""G1: points of E(Fp): y^2 = x^3 + 4, as batched Jacobian word tensors.

`mul` is kernel K3 (with its scalar recoding on K1); add/sub/double are
the plain masked-select Jacobian formulas with their products on K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fp, fr
from ..field.constants import G1_GENERATOR_X, G1_GENERATOR_Y
from .kernels import g1_scalar_mul
from .weierstrass import CurveOps, JacobianPoint

ops = CurveOps(fp)

add = ops.add
sub = ops.sub
double = ops.double
neg = ops.neg
select = ops.select
is_infinity = ops.is_infinity
to_affine = ops.to_affine


def _const_point(x: int, y: int, z: int, shape, device) -> JacobianPoint:
    return JacobianPoint(*(
        fp.from_int(v, device).expand(tuple(shape) + (fp.N_WORDS,))
        .contiguous() for v in (x, y, z)))


def generator(shape=(), device="cuda") -> JacobianPoint:
    return _const_point(G1_GENERATOR_X, G1_GENERATOR_Y, 1, shape, device)


def infinity(shape=(), device="cuda") -> JacobianPoint:
    return _const_point(1, 1, 0, shape, device)


def mul(p: JacobianPoint, scalars_mont) -> JacobianPoint:
    """MulG1 batched: p * scalar per lane (p and the Fr scalars
    broadcast). The whole signed-window ladder is one K3 launch."""
    digits = fr.scalar_windows_signed(scalars_mont)
    shape = torch.broadcast_shapes(p.x.shape[:-1], digits.shape[:-1])
    p = JacobianPoint(*(c.expand(shape + (fp.N_WORDS,)).contiguous()
                        for c in p))
    digits = digits.expand(shape + (digits.shape[-1],)).contiguous()
    return g1_scalar_mul(p, digits)


def from_affine_ints(coords, device="cuda") -> JacobianPoint:
    """[(x, y) or None, ...] -> (n,) Jacobian batch; None is infinity."""
    xs, ys, zs = [], [], []
    for c in coords:
        if c is None:
            xs.append(1), ys.append(1), zs.append(0)
        else:
            xs.append(c[0]), ys.append(c[1]), zs.append(1)
    return JacobianPoint(fp.from_int(xs, device), fp.from_int(ys, device),
                         fp.from_int(zs, device))


def to_affine_ints(p: JacobianPoint) -> list:
    """(n,) batch -> list of (x, y) int pairs, None for infinity."""
    x, y, inf = to_affine(p)
    xs = fp.to_int(x).reshape(-1)
    ys = fp.to_int(y).reshape(-1)
    infs = np.asarray(inf.cpu()).reshape(-1)
    return [None if i else (int(a), int(b)) for a, b, i in zip(xs, ys, infs)]
