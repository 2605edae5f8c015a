"""Multi-scalar multiplication (the reference's LinCombG1; the shared-table
windowed MSM of kzg_tpu/curve/msm.py:36-182):

    sum_i k_i P_i  =  sum_j 16^j S_j,    S_j = sum_i s_ij P_i

with s_ij the signed 4-bit digits of k_i (fr.scalar_windows_signed). Each
point builds one multiples table [0..8]P_i (7 batched adds, shared by all
64 windows); each window sum S_j is a table lookup, with y negated for a
negative digit, then a batched tree sum over the point axis with all 64
windows side by side, so each tree level is one add over the whole block.
The final combine is a 63-step Horner loop (4 doublings + 1 add per
window) on one point per MSM. With `g1.ops_kernel` every point op is one
launch of the point kernels.
"""

from __future__ import annotations

import torch

from ..field import fr
from . import g1
from .weierstrass import JacobianPoint, map_points

N_WINDOWS = 64


def tree_reduce(ops, points: JacobianPoint) -> JacobianPoint:
    """Sum a (N, ...) point batch along axis 0 by halving: each level adds
    the second half of the rows to the first, one batched add (an odd
    level is padded with infinity). The halves are contiguous views."""
    n = points.x.shape[0]
    while n > 1:
        if n % 2 == 1:
            pad = ops.infinity_like(map_points(lambda c: c[:1], points))
            points = map_points(lambda c, p: torch.cat((c, p)), points, pad)
            n += 1
        n //= 2
        points = ops.add(map_points(lambda c: c[:n], points),
                         map_points(lambda c: c[n:], points))
    return map_points(lambda c: c[0], points)


def _multiples_table(ops, p: JacobianPoint) -> JacobianPoint:
    """[0..8]P stacked on a new leading axis: coords (9, N, 12). The first
    add, P + P, goes through the add's doubling branch."""
    mults = [ops.infinity_like(p), p]
    for _ in range(7):
        mults.append(ops.add(mults[-1], p))
    return map_points(lambda *cs: torch.stack(cs), *mults)


def window_sums(ops, points: JacobianPoint, scalars_mont) -> JacobianPoint:
    """Per-window sums S_j = sum_i s_ij P_i. points: (N,) batch; scalars:
    (..., N, 8) Fr Montgomery words (leading dims are independent MSMs over
    the same points). Returns coords (..., 64, 12)."""
    n = points.x.shape[0]
    if scalars_mont.shape[-2] != n:
        raise ValueError(f"{scalars_mont.shape[-2]} scalars for {n} points")
    digits = torch.movedim(fr.scalar_windows_signed(scalars_mont), -2, 0)
    table = _multiples_table(ops, points)               # (9, N, 12)
    mag = digits.abs().long()                           # (N, ..., 64)
    lane = torch.arange(n, device=mag.device).reshape(
        (n,) + (1,) * (mag.dim() - 1))
    sel = map_points(lambda c: c[mag, lane], table)     # (N, ..., 64, 12)
    y = ops.F.select(digits < 0, ops.F.neg(sel.y), sel.y)
    return tree_reduce(ops, JacobianPoint(sel.x, y, sel.z))


def horner_windows(ops, wsums: JacobianPoint) -> JacobianPoint:
    """acc = sum_j 16^j S_j for LSB-first window sums, coords
    (..., 64, 12) -> (..., 12): 63 x (4 doublings + 1 add)."""
    w = map_points(lambda c: c.movedim(-2, 0).contiguous(), wsums)
    acc = map_points(lambda c: c[N_WINDOWS - 1], w)
    for j in range(N_WINDOWS - 2, -1, -1):
        for _ in range(4):
            acc = ops.double(acc)
        acc = ops.add(acc, map_points(lambda c: c[j], w))
    return acc


def lin_comb_g1(points: JacobianPoint, scalars_mont) -> JacobianPoint:
    """MSM: sum_i scalars[..., i] * points[i]. points: (N,) G1 batch;
    scalars: (..., N, 8) Fr Montgomery words. Returns coords (..., 12)."""
    ops = g1.ops_kernel
    return horner_windows(ops, window_sums(ops, points, scalars_mont))


def sum_g1(points: JacobianPoint) -> JacobianPoint:
    return tree_reduce(g1.ops_kernel, points)
