"""G2: points of E'(Fp2): y^2 = x^3 + 4(u + 1), as batched Jacobian
tensors with Fp2 coordinates (..., 2, 12) (kzg_tpu/curve/g2.py).

`mul` is kernel K-a (`g2_scalar_mul`, after one `fr_signed_windows`
launch); add/sub/double are the generic masked-select Jacobian formulas
on `fp2`, their products on K1; `in_subgroup` is [r - 1]Q == -Q on K-a.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr
from ..field.constants import G2_GENERATOR_X, G2_GENERATOR_Y
from . import fp2
from .pairing_kernels import g2_scalar_mul
from .weierstrass import CurveOps, JacobianPoint


def _const_point(x, y, z, shape, device) -> JacobianPoint:
    return JacobianPoint(*(
        fp2.from_int(list(v), device).expand(tuple(shape) + (2, 12))
        .contiguous() for v in (x, y, z)))


def generator(shape=(), device="cuda") -> JacobianPoint:
    return _const_point(G2_GENERATOR_X, G2_GENERATOR_Y, (1, 0), shape,
                        device)


def infinity(shape=(), device="cuda") -> JacobianPoint:
    return _const_point((1, 0), (1, 0), (0, 0), shape, device)


def mul(p: JacobianPoint, scalars_mont) -> JacobianPoint:
    """MulG2 batched: p * scalar per lane (p and the Fr scalars
    broadcast), one K-a launch."""
    digits = fr.scalar_windows_signed(scalars_mont)
    shape = torch.broadcast_shapes(p.x.shape[:-2], digits.shape[:-1])
    p = JacobianPoint(*(c.expand(shape + (2, 12)).contiguous() for c in p))
    digits = digits.expand(shape + (digits.shape[-1],)).contiguous()
    return g2_scalar_mul(p, digits)


ops = CurveOps(fp2, mul)

add = ops.add
sub = ops.sub
neg = ops.neg
double = ops.double
eq = ops.eq
select = ops.select
is_infinity = ops.is_infinity
to_affine = ops.to_affine
from_affine = ops.from_affine
in_subgroup = ops.in_subgroup
mul_small = ops.mul_small


def from_affine_ints(coords, device="cuda") -> JacobianPoint:
    """[((x0, x1), (y0, y1)) or None, ...] -> (n,) Jacobian batch; None is
    infinity ((1, 0), (1, 0), (0, 0))."""
    one, zero = (1, 0), (0, 0)
    xs = [one if c is None else c[0] for c in coords]
    ys = [one if c is None else c[1] for c in coords]
    zs = [zero if c is None else one for c in coords]
    return JacobianPoint(*(fp2.from_int(v, device) for v in (xs, ys, zs)))


def to_affine_ints(p: JacobianPoint) -> list:
    """(n,) batch -> [((x0, x1), (y0, y1)) or None]."""
    x, y, inf = to_affine(p)
    xs = fp2.to_int(x).reshape(-1, 2)
    ys = fp2.to_int(y).reshape(-1, 2)
    infs = np.asarray(inf.cpu()).reshape(-1)
    return [None if i else ((int(a[0]), int(a[1])), (int(b[0]), int(b[1])))
            for a, b, i in zip(xs, ys, infs)]
