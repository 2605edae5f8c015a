"""Short-Weierstrass (a = 0) Jacobian point arithmetic, branchless.

Points are `JacobianPoint`s of word tensors (X, Y, Z), x = X/Z^2 and
y = Y/Z^3; infinity is Z == 0 (built here as (1, 1, 0), while the ladder
kernels return all-zero words: compare points in affine form). Every edge
case (infinity, doubling, P == -Q) is a masked select, as in
kzg_tpu/curve/weierstrass.py; each field product runs on kernel K1. The
field is `fp` (G1) or `curve.fp2` (G2): every op treats the leading axes
as batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..field import fr
from ..field.constants import FR_MODULUS


class JacobianPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def map_points(fn, *ps: JacobianPoint) -> JacobianPoint:
    """Apply fn coordinate-wise across points."""
    return JacobianPoint(*(fn(*cs) for cs in zip(*ps)))


class CurveOps:
    def __init__(self, F, scalar_mul):
        """F: the field module; scalar_mul: the curve's ladder kernel
        (points, Fr Montgomery scalars) -> points."""
        self.F = F
        self.scalar_mul = scalar_mul

    def from_affine(self, x, y) -> JacobianPoint:
        return JacobianPoint(x, y, self.F.one_like(x))

    def infinity_like(self, p: JacobianPoint) -> JacobianPoint:
        one = self.F.one_like(p.x)
        return JacobianPoint(one, one.clone(), torch.zeros_like(p.z))

    def is_infinity(self, p: JacobianPoint):
        return self.F.is_zero(p.z)

    def _mul_tier(self, xs, ys):
        """One F.mul (one kernel launch) over stacked operand tuples."""
        t = self.F.mul(torch.stack(torch.broadcast_tensors(*xs)),
                       torch.stack(torch.broadcast_tensors(*ys)))
        return tuple(t.unbind(0))

    def double(self, p: JacobianPoint) -> JacobianPoint:
        """dbl-2009-l (a = 0). Infinity -> infinity (Z3 = 2YZ = 0)."""
        F = self.F
        a, b, yz = self._mul_tier((p.x, p.y, p.y), (p.x, p.y, p.z))
        xb = F.add(p.x, b)
        c, xb2 = self._mul_tier((b, xb), (b, xb))
        d = F.sub(xb2, F.add(a, c))
        d = F.add(d, d)
        e = F.add(F.add(a, a), a)
        f = F.mul(e, e)
        x3 = F.sub(f, F.add(d, d))
        c8 = F.add(c, c)
        c8 = F.add(c8, c8)
        c8 = F.add(c8, c8)
        y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
        z3 = F.add(yz, yz)
        return JacobianPoint(x3, y3, z3)

    def add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        """Complete add (add-2007-bl core with masked selects for P == Q,
        P == -Q and either operand at infinity)."""
        F = self.F
        zsum = F.add(p.z, q.z)
        z1z1, z2z2, ta, tb, zz = self._mul_tier(
            (p.z, q.z, p.y, q.y, zsum), (p.z, q.z, q.z, p.z, zsum))
        u1, u2, s1, s2 = self._mul_tier(
            (p.x, q.x, ta, tb), (z2z2, z1z1, z2z2, z1z1))
        h = F.sub(u2, u1)
        rr = F.sub(s2, s1)
        h2 = F.add(h, h)
        zred = F.sub(zz, F.add(z1z1, z2z2))
        i, z3 = self._mul_tier((h2, zred), (h2, h))
        rr2 = F.add(rr, rr)
        j, v, r4 = self._mul_tier((h, u1, rr2), (i, i, rr2))
        x3 = F.sub(r4, F.add(j, F.add(v, v)))
        s1j, t5 = self._mul_tier((s1, rr2), (j, F.sub(v, x3)))
        y3 = F.sub(t5, F.add(s1j, s1j))
        res = JacobianPoint(x3, y3, z3)

        same_x = F.is_zero(h)
        same_y = F.is_zero(rr)
        p_inf = self.is_infinity(p)
        q_inf = self.is_infinity(q)
        both = ~p_inf & ~q_inf
        res = self.select(same_x & same_y & both, self.double(p), res)
        res = self.select(same_x & ~same_y & both, self.infinity_like(p), res)
        res = self.select(q_inf, p, res)
        return self.select(p_inf, q, res)

    def neg(self, p: JacobianPoint) -> JacobianPoint:
        return JacobianPoint(p.x, self.F.neg(p.y), p.z)

    def sub(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        return self.add(p, self.neg(q))

    def select(self, mask, a: JacobianPoint, b: JacobianPoint):
        return map_points(lambda u, v: self.F.select(mask, u, v), a, b)

    def eq(self, p: JacobianPoint, q: JacobianPoint):
        """Projective equality by cross-multiplied coordinates; both at
        infinity (any Z == 0 encoding) are equal."""
        F = self.F
        z1z1, z2z2 = F.sqr(p.z), F.sqr(q.z)
        u1, u2, s1, s2 = self._mul_tier(
            (p.x, q.x, p.y, q.y), (z2z2, z1z1, q.z, p.z))
        s1, s2 = self._mul_tier((s1, s2), (z2z2, z1z1))
        p_inf, q_inf = self.is_infinity(p), self.is_infinity(q)
        return (p_inf & q_inf) | (~p_inf & ~q_inf & F.eq(u1, u2)
                                  & F.eq(s1, s2))

    def mul_small(self, p: JacobianPoint, k: int) -> JacobianPoint:
        """p * k for a static non-negative int: double-and-add MSB first,
        branching in Python on each bit."""
        acc = self.infinity_like(p)
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return acc

    def in_subgroup(self, p: JacobianPoint):
        """r-torsion membership mask, [r]P == O (the cofactors are large,
        so on-curve does not imply it; kzg_tpu/curve/weierstrass.py:
        280-287). The ladder takes Fr scalars, where r itself is 0, so
        the test is [r - 1]P == -P, one launch."""
        k = fr.from_int(FR_MODULUS - 1, p.x.device)
        return self.eq(self.scalar_mul(p, k), self.neg(p))

    def to_affine(self, p: JacobianPoint):
        """-> (x, y, is_infinity); infinity maps to (0, 0, True)."""
        F = self.F
        zinv = F.inv(p.z)
        zinv2 = F.sqr(zinv)
        x = F.mul(p.x, zinv2)
        y = F.mul(p.y, F.mul(zinv, zinv2))
        inf = self.is_infinity(p)
        zero = torch.zeros_like(x)
        return F.select(inf, zero, x), F.select(inf, zero, y), inf
