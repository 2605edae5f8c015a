"""G1: points of E(Fp): y^2 = x^3 + 4, as batched Jacobian word tensors.

`mul` is kernel K3 (after one `fr_signed_windows` launch); add/sub/double
are the plain masked-select Jacobian formulas with their products on K1;
`in_subgroup` is [r - 1]P == -P on K3.
`ops_kernel` is the same curve interface with add and double on the point
kernels, one launch each, for the MSM and FK20's tree sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fp, fr
from ..field.constants import FP_MODULUS, G1_GENERATOR_X, G1_GENERATOR_Y
from .kernels import g1_add, g1_double, g1_scalar_mul
from .weierstrass import CurveOps, JacobianPoint, map_points

class KernelG1Ops:
    """CurveOps-shaped facade whose add and double are the point kernels
    (kzg_tpu/curve/pallas_g1.py::PallasG1Ops): one launch per point op
    over the whole batch. Its infinity is all-zero words, as the kernels
    make it for P + (-P)."""

    F = fp

    def infinity_like(self, p: JacobianPoint) -> JacobianPoint:
        return JacobianPoint(*(torch.zeros_like(p.z) for _ in range(3)))

    def is_infinity(self, p: JacobianPoint):
        return fp.is_zero(p.z)

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return g1_add(p, q)

    def double(self, p: JacobianPoint) -> JacobianPoint:
        return g1_double(p)

    def neg(self, p: JacobianPoint) -> JacobianPoint:
        return JacobianPoint(p.x, fp.neg(p.y), p.z)

    def sub(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return g1_add(p, self.neg(q))

    def select(self, mask, a: JacobianPoint, b: JacobianPoint):
        return map_points(lambda u, v: fp.select(mask, u, v), a, b)


ops_kernel = KernelG1Ops()


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


ops = CurveOps(fp, mul)

add = ops.add
sub = ops.sub
double = ops.double
neg = ops.neg
select = ops.select
is_infinity = ops.is_infinity
to_affine = ops.to_affine
eq = ops.eq
in_subgroup = ops.in_subgroup
mul_small = ops.mul_small


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


def to_affine_ints_host(p: JacobianPoint) -> list:
    """(...,) batch -> flat list of (x, y) int pairs, None for infinity,
    with the inverses on the host: one copy from the device and no
    launch, the cheaper way for a few points."""
    xs, ys, zs = (fp.to_int(c).reshape(-1) for c in p)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = pow(int(z), -1, FP_MODULUS)
        zi2 = zi * zi % FP_MODULUS
        out.append((int(x) * zi2 % FP_MODULUS,
                    int(y) * zi2 * zi % FP_MODULUS))
    return out


def to_affine_ints(p: JacobianPoint) -> list:
    """(n,) batch -> list of (x, y) int pairs, None for infinity."""
    x, y, inf = to_affine(p)
    xs = fp.to_int(x).reshape(-1)
    ys = fp.to_int(y).reshape(-1)
    infs = np.asarray(inf.cpu()).reshape(-1)
    return [None if i else (int(a), int(b)) for a, b, i in zip(xs, ys, infs)]
