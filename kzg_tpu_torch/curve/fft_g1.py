"""Mixed-radix (I)FFT over G1 points (reference: fft_g1.go:11-94).

A plan is a tuple of radices (r_1, ..., r_s), product n, run as
decimation-in-time stages on digit-reversed input. After stage t the
array holds DFTs of size m = r_1 ... r_t in blocks; stage t combines r_t
of them:
    out[b m + q + m' k] = sum_{j < r} w_m^(j (q + m' k)) in[b m + j m' + q]
with m' = m / r, for k, j < r: one group (b, q) of r inputs and r outputs.
A radix-2 stage runs on the butterfly kernel K4 (`g1_glv_butterfly`, one
GLV ladder a group, lo = A + tB, hi = A - tB); a wider one on
`g1_fft_stage` (one GLV ladder a term, the r terms of an output summed in
the block), after `g1_window_table` has built each input's [1..8] table
once. At n <= 128 the plan is one dense stage, r = n: one launch of each
per transform. The inverse's 1/n is folded into one wide stage's scalars
(the transform is linear); a plan of radix-2 stages alone ends with one
more K4 butterfly with A = infinity, lo = O + (1/n) P
(kzg_tpu/curve/fft_g1.py:172-181).

Every scalar is a power of a root of unity (times 1/n), so its GLV digit
rows are computed once on the host per (n, direction, plan) and kept on
the device. Points must lie in the r-torsion subgroup, as every CRS,
commitment and proof point does.

Unlike the JAX package, leading batch axes are allowed: (..., n) points
transform together, one launch per stage for the whole batch.

`fft_g1(..., in_subgroup=False)` takes the reference's radix-2 route
instead, on K3 and `g1_add`, which holds for any point of the curve.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fp, fr
from ..ntt.bitrev import brp_permute
from ..ntt.domain import FFTSettings, _expanded_roots_int
from . import g1, glv
from .kernels import (
    STAGE_THREADS,
    g1_fft_stage,
    g1_glv_butterfly,
    g1_window_table,
)
from .weierstrass import JacobianPoint, map_points

# The radix of the plan for n > 128, chosen by timing the 8192-point
# plans on the card (PERF.md): radix-4 stages run 2 warps a scheduler,
# enough to cover much of a ladder's latency, and add half the terms of
# radix 8.
WIDE_RADIX = 4


def default_plan(n: int) -> tuple:
    """One dense stage up to 128 points; above, radix-WIDE_RADIX stages
    after one narrower stage that takes the rest of log2 n (8192 points:
    (2, 4, 4, 4, 4, 4, 4))."""
    if n <= STAGE_THREADS:
        return (n,)
    return mixed_plan(n, WIDE_RADIX)


def mixed_plan(n: int, r: int) -> tuple:
    """(n / r^k, r, ..., r) with the first stage in (1, r]: e.g. 8192 at
    r = 8 is (2, 8, 8, 8, 8)."""
    log_n, log_r = n.bit_length() - 1, r.bit_length() - 1
    full, rest = divmod(log_n, log_r)
    return ((1 << rest,) if rest else ()) + (r,) * full


def digit_reversal(plan: tuple) -> np.ndarray:
    """Input order of the first stage: position p holds x[perm[p]]. The
    last stage's radix is the fastest digit of the input index; for a
    radix-2 plan this is the bit reversal."""
    perm = np.zeros(1, dtype=np.int64)
    for r in plan:
        perm = (np.arange(r)[:, None] + r * perm[None, :]).reshape(-1)
    return perm


def _check_plan(n: int, plan: tuple) -> None:
    if int(np.prod(plan)) != n or any(
            r < 2 or r & (r - 1) or r > STAGE_THREADS for r in plan):
        raise ValueError(f"plan {plan} is not radices in [2, "
                         f"{STAGE_THREADS}] with product {n}")


@functools.lru_cache(maxsize=None)
def _plan_host(max_scale: int, n: int, inverse: bool, plan: tuple,
               inv_n: int | None = None):
    """Host tables of each stage: ("bf", d1, d2) for a radix-2 stage on
    K4, with int32 (n/2, 33) digit rows over its butterflies; ("wide", r,
    src, dst, digits) for a g1_fft_stage, with src and dst int32 (n,) and
    digits int8 (m', r, r, 2, 33). Plus the inverse's scale digits (1, 33)
    twice when no wide stage takes the scale, else None. The inverse's
    scale is inv_n, or 1/n when it is None."""
    roots = _expanded_roots_int(max_scale)
    if inverse:
        roots = tuple(reversed(roots))
    max_width = 1 << max_scale
    if not inverse:
        inv_n = 1
    elif inv_n is None:
        inv_n = pow(n, -1, fr.SPEC.modulus)
    wide = [t for t, r in enumerate(plan) if r > 2]
    fold = wide[-1] if inverse and wide else None
    perm = digit_reversal(plan)
    stages, m = [], 1
    for t, r in enumerate(plan):
        mp, m = m, m * r
        stride = max_width // m
        if r == 2:
            d1, d2 = glv.twiddle_digits([roots[q * stride] for q in range(mp)])
            stages.append(("bf", np.tile(d1, (n // m, 1)),
                           np.tile(d2, (n // m, 1))))
            continue
        scale = inv_n if t == fold else 1
        pd1, pd2 = glv.twiddle_digits(
            [roots[e * stride] * scale % fr.SPEC.modulus for e in range(m)])
        pows = np.stack((pd1, pd2), axis=1).astype(np.int8)  # (m, 2, 33)
        q = np.arange(mp)[:, None, None]
        k = np.arange(r)[None, :, None]
        j = np.arange(r)[None, None, :]
        digits = pows[(j * (q + mp * k)) % m]                # (m', r, r, ..)
        # input j and output k of group gl = (b, q) sit at b m + q + m' j
        # (k); the first stage reads the input through the permutation
        gl = np.arange(n // r)
        dst = ((gl // mp * m + gl % mp)[:, None]
               + mp * np.arange(r)[None, :]).reshape(-1)
        src = perm[dst] if t == 0 else dst
        stages.append(("wide", r, src.astype(np.int32),
                       dst.astype(np.int32), np.ascontiguousarray(digits)))
    first_bf = plan[0] == 2
    scale_digits = None
    if inverse and fold is None:
        scale_digits = glv.twiddle_digits([inv_n])
    return tuple(stages), (perm if first_bf else None), scale_digits


@functools.lru_cache(maxsize=None)
def _plan_device(max_scale: int, n: int, inverse: bool, plan: tuple,
                 device: torch.device, inv_n: int | None = None):
    """_plan_host's tables as device tensors, copied once."""
    stages, perm, scale = _plan_host(max_scale, n, inverse, plan, inv_n)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = tuple(("bf", dev(s[1]), dev(s[2])) if s[0] == "bf" else
                ("wide", s[1], dev(s[2]), dev(s[3]), dev(s[4]))
                for s in stages)
    return (out, None if perm is None else dev(perm),
            None if scale is None else tuple(dev(d) for d in scale))


def _rows(d: torch.Tensor, reps: int) -> torch.Tensor:
    return d if reps == 1 else d.repeat(reps, 1)


def _fft_g1_core(points: JacobianPoint, max_scale: int, inverse: bool,
                 plan: tuple, inv_n: int | None = None) -> JacobianPoint:
    """fft_g1 on the radix plan `plan` (radices with product n). The
    inverse is scaled by inv_n, a canonical int, or by 1/n when it is
    None: a sharded transform's local inverse takes 1/n of the whole."""
    n = points.x.shape[-2]
    _check_plan(n, plan)
    batch_shape = points.x.shape[:-2]
    dev = points.x.device
    stages, perm, scale = _plan_device(max_scale, n, inverse, plan, dev,
                                       inv_n)
    pts = map_points(lambda c: c.reshape(-1, n, fp.N_WORDS), points)
    B = pts.x.shape[0]
    if perm is not None:
        pts = map_points(lambda c: c[:, perm], pts)
    m = 1
    for stage in stages:
        if stage[0] == "wide":
            _, r, src, dst, digits = stage
            m *= r
            flat = map_points(lambda c: c.reshape(-1, fp.N_WORDS)
                              .contiguous(), pts)
            tables = g1_window_table(flat, 1, src, n)
            out = g1_fft_stage(tables, digits, dst, n, r)
            pts = map_points(lambda c: c.reshape(B, n, fp.N_WORDS), out)
            continue
        _, d1, d2 = stage
        m *= 2
        half = m >> 1
        resh = map_points(lambda c: c.reshape(B, n // m, m, fp.N_WORDS), pts)
        a = map_points(lambda c: c[:, :, :half].reshape(-1, fp.N_WORDS)
                       .contiguous(), resh)
        b = map_points(lambda c: c[:, :, half:].reshape(-1, fp.N_WORDS)
                       .contiguous(), resh)
        lo, hi = g1_glv_butterfly(a, b, _rows(d1, B), _rows(d2, B))
        pts = map_points(
            lambda l, h: torch.cat(
                (l.reshape(B, n // m, half, fp.N_WORDS),
                 h.reshape(B, n // m, half, fp.N_WORDS)), dim=2)
            .reshape(B, n, fp.N_WORDS), lo, hi)
    if scale is not None:
        d1, d2 = scale
        flat = map_points(lambda c: c.reshape(-1, fp.N_WORDS).contiguous(),
                          pts)
        inf = g1.infinity((B * n,), dev)
        pts, _ = g1_glv_butterfly(inf, flat, _rows(d1, B * n),
                                  _rows(d2, B * n))
    return map_points(
        lambda c: c.reshape(batch_shape + (n, fp.N_WORDS)), pts)


def _fft_g1_generic(fs: FFTSettings, points: JacobianPoint,
                    inverse: bool) -> JacobianPoint:
    """The radix-2 route for any curve point (kzg_tpu/curve/fft_g1.py:
    76-101): the input in bit-reversed order, then per stage t = [w]b on
    K3 (`g1.mul`: one fr_signed_windows and one g1_scalar_mul launch) and
    (lo, hi) = (a + t, a - t) in one g1_add launch; an inverse ends with
    a K3 product by 1/n."""
    n = points.x.shape[-2]
    batch_shape = points.x.shape[:-2]
    dev = points.x.device
    roots = (fs.reverse_roots_of_unity if inverse
             else fs.expanded_roots_of_unity)
    pts = map_points(lambda c: brp_permute(c.reshape(-1, n, fp.N_WORDS)),
                     points)
    B = pts.x.shape[0]
    m = 1
    while m < n:
        m *= 2
        half = m >> 1
        stride = fs.max_width // m
        resh = map_points(lambda c: c.reshape(B, n // m, m, fp.N_WORDS), pts)
        a = map_points(lambda c: c[:, :, :half], resh)
        t = g1.mul(map_points(lambda c: c[:, :, half:], resh),
                   roots[:half * stride:stride])
        # (a, a) + (t, -t): lo and hi in one launch, then side by side
        both = g1.ops_kernel.add(
            map_points(lambda c: torch.cat((c, c)), a),
            map_points(lambda u, v: torch.cat((u, v)), t,
                       g1.ops_kernel.neg(t)))
        pts = map_points(lambda c: torch.cat((c[:B], c[B:]), dim=2)
                         .reshape(B, n, fp.N_WORDS), both)
    if inverse:
        pts = g1.mul(pts, fr.from_int(pow(n, -1, fr.SPEC.modulus), dev))
    return map_points(
        lambda c: c.reshape(batch_shape + (n, fp.N_WORDS)), pts)


def fft_g1(fs: FFTSettings, points: JacobianPoint, inverse: bool = False,
           in_subgroup: bool = True) -> JacobianPoint:
    """(I)FFT of (..., n) G1 points along the point axis; n a power of
    two <= fs.max_width (reference: fft_g1.go:62-68).

    in_subgroup=True (the default) runs `default_plan(n)` on the GLV
    kernels, whose scalars assume phi(P) == lambda P: true only in the
    r-torsion subgroup, where every point of this package lies (CRS,
    commitments, proofs, points decompressed with the subgroup check).
    For points of unknown order (decompressed with subgroup_check=False)
    pass in_subgroup=False: the radix-2 route on K3 and g1_add, correct
    for any curve point."""
    n = points.x.shape[-2]
    if n > fs.max_width:
        raise ValueError("got more values than roots of unity")
    if n & (n - 1) != 0:
        raise ValueError("got a non-power-of-two number of values")
    if n == 1:
        return points
    if not in_subgroup:
        return _fft_g1_generic(fs, points, inverse)
    return _fft_g1_core(points, fs.max_scale, inverse, default_plan(n))


def reverse_bit_order_g1(points: JacobianPoint) -> JacobianPoint:
    """reference: reverseBitOrderG1 (fft_g1.go:97-107)."""
    return map_points(lambda c: brp_permute(c, axis=-2), points)
