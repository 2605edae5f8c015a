"""Multi-scalar multiplication (the reference's LinCombG1; the shared-table
windowed MSM of kzg_tpu/curve/msm.py:36-182):

    sum_i k_i P_i  =  sum_j 16^j S_j,    S_j = sum_i s_ij P_i

with s_ij the signed 4-bit digits of k_i (fr.scalar_windows_signed).

Variable bases (`lin_comb_g1`): each point builds one multiples table
[0..8]P_i (7 batched `g1_add` launches through `g1.ops_kernel`, shared
by all 64 windows); each window sum S_j is a table lookup, with y negated
for a negative digit, then one `g1_sum` over the point axis with all 64
windows side by side; `g1_horner` combines the 64 sums of each MSM in one
launch.

Fixed bases (`lin_comb_fixed`, the commitment on the CRS): with the
bases' 64-window tables (`fixed_base_tables`, built once by the caller)
each k_i P_i is one `g1_fixed_base_mul` lane, with no doubling, and one
`g1_sum` adds them.
"""

from __future__ import annotations

import torch

from ..field import fp, fr
from . import g1
from .kernels import (
    FIXED_WINDOWS,
    g1_fixed_base_mul,
    g1_horner,
    g1_sum,
    g1_window_table,
)
from .weierstrass import JacobianPoint, map_points


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


def window_points(points: JacobianPoint, scalars_mont) -> JacobianPoint:
    """s_ij P_i for every point i and window j. points: (N,) batch;
    scalars: (..., N, 8) Fr Montgomery words (leading dims are independent
    MSMs over the same points). Returns coords (N, ..., 64, 12)."""
    n = points.x.shape[0]
    if scalars_mont.shape[-2] != n:
        raise ValueError(f"{scalars_mont.shape[-2]} scalars for {n} points")
    digits = torch.movedim(fr.scalar_windows_signed(scalars_mont), -2, 0)
    table = _multiples_table(g1.ops_kernel, points)     # (9, N, 12)
    mag = digits.abs().long()                           # (N, ..., 64)
    lane = torch.arange(n, device=mag.device).reshape(
        (n,) + (1,) * (mag.dim() - 1))
    sel = map_points(lambda c: c[mag, lane], table)     # (N, ..., 64, 12)
    return JacobianPoint(sel.x, fp.select(digits < 0, fp.neg(sel.y), sel.y),
                         sel.z)


def window_sums(points: JacobianPoint, scalars_mont) -> JacobianPoint:
    """Per-window sums S_j = sum_i s_ij P_i, coords (..., 64, 12): one
    g1_sum over the point axis."""
    return g1_sum(window_points(points, scalars_mont), dim=0)


def lin_comb_g1(points: JacobianPoint, scalars_mont) -> JacobianPoint:
    """MSM: sum_i scalars[..., i] * points[i]. points: (N,) G1 batch;
    scalars: (..., N, 8) Fr Montgomery words. Returns coords (..., 12)."""
    return g1_horner(window_sums(points, scalars_mont))


def fixed_base_tables(bases: JacobianPoint) -> torch.Tensor:
    """The 64-window fixed-base tables of (..., N) bases, int32
    (..., N, 64, 8, 36): entry m of window w of base B is (m+1) 16^w B
    (g1_window_table; 144 bytes an entry, 604 MB at 8192 bases)."""
    shape = tuple(bases.x.shape[:-1])
    flat = map_points(lambda c: c.reshape(-1, fp.N_WORDS).contiguous(),
                      bases)
    return g1_window_table(flat, FIXED_WINDOWS).reshape(
        shape + (FIXED_WINDOWS, 8, 3 * fp.N_WORDS))


def lin_comb_fixed(tables: torch.Tensor, scalars_mont) -> JacobianPoint:
    """MSM on fixed bases: sum_i scalars[..., i] * B_i from the bases'
    64-window tables (N, 64, 8, 36) (fixed_base_tables). scalars:
    (..., N, 8) Fr Montgomery words. Returns coords (..., 12)."""
    digits = fr.scalar_windows_signed(scalars_mont)
    if digits.shape[-2] != tables.shape[0]:
        raise ValueError(f"{digits.shape[-2]} scalars for "
                         f"{tables.shape[0]} bases")
    prods = g1_fixed_base_mul(tables, digits.reshape(-1, FIXED_WINDOWS))
    return g1_sum(map_points(
        lambda c: c.reshape(digits.shape[:-1] + (fp.N_WORDS,)), prods))


def sum_g1(points: JacobianPoint) -> JacobianPoint:
    """The sum of a (N, ...) point batch along axis 0."""
    return g1_sum(points, dim=0)
