"""Radix-2 (I)FFT over G1 points (reference: fft_g1.go:11-94), one launch
of kernel K4 per stage.

The twiddles are static domain constants, so each stage's GLV digit rows
are computed once on the host (curve/glv.py). The inverse transform's 1/n
is one more K4 butterfly with A = infinity, lo = O + (1/n) P
(kzg_tpu/curve/fft_g1.py:172-181). Points must lie in the r-torsion
subgroup, as every CRS, commitment and proof point does.

Unlike the JAX package, leading batch axes are allowed: (..., n) points
transform together, one launch per stage for the whole batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fp, fr
from ..ntt.bitrev import brp_permute
from ..ntt.domain import FFTSettings, _expanded_roots_int
from . import g1, glv
from .kernels import g1_glv_butterfly
from .weierstrass import JacobianPoint, map_points


@functools.lru_cache(maxsize=None)
def _stage_digits(max_scale: int, n: int, inverse: bool, inv_scale):
    """Host GLV digit tables: per_stage[s-1] = (d1, d2) int32 (n/2, 33)
    over the flattened (n/m groups x half) butterflies of stage s; and
    (d1, d2) of shape (1, 33) for the inverse scale, or None."""
    roots = _expanded_roots_int(max_scale)
    if inverse:
        roots = tuple(reversed(roots))
    max_width = 1 << max_scale
    per_stage = []
    for s in range(1, n.bit_length()):
        m = 1 << s
        half = m >> 1
        stride = max_width // m
        d1, d2 = glv.twiddle_digits([roots[j * stride] for j in range(half)])
        per_stage.append((np.tile(d1, (n // m, 1)), np.tile(d2, (n // m, 1))))
    inv_digits = None
    if inv_scale is not None:
        inv_digits = glv.twiddle_digits([inv_scale % fr.SPEC.modulus])
    return tuple(per_stage), inv_digits


def _tiled(d: np.ndarray, reps: int, device) -> torch.Tensor:
    return torch.from_numpy(np.tile(d, (reps, 1))).to(device)


def _fft_g1_core(points: JacobianPoint, max_scale: int, inverse: bool,
                 inv_scale) -> JacobianPoint:
    n = points.x.shape[-2]
    batch_shape = points.x.shape[:-2]
    dev = points.x.device
    per_stage, inv_digits = _stage_digits(max_scale, n, inverse, inv_scale)
    pts = map_points(
        lambda c: brp_permute(c, axis=-2).reshape(-1, n, fp.N_WORDS), points)
    B = pts.x.shape[0]
    for s, (d1, d2) in enumerate(per_stage, start=1):
        m = 1 << s
        half = m >> 1
        resh = map_points(lambda c: c.reshape(B, n // m, m, fp.N_WORDS), pts)
        a = map_points(lambda c: c[:, :, :half].reshape(-1, fp.N_WORDS)
                       .contiguous(), resh)
        b = map_points(lambda c: c[:, :, half:].reshape(-1, fp.N_WORDS)
                       .contiguous(), resh)
        lo, hi = g1_glv_butterfly(a, b, _tiled(d1, B, dev),
                                  _tiled(d2, B, dev))
        pts = map_points(
            lambda l, h: torch.cat(
                (l.reshape(B, n // m, half, fp.N_WORDS),
                 h.reshape(B, n // m, half, fp.N_WORDS)), dim=2)
            .reshape(B, n, fp.N_WORDS), lo, hi)
    if inv_digits is not None:
        d1, d2 = inv_digits
        flat = map_points(lambda c: c.reshape(-1, fp.N_WORDS).contiguous(),
                          pts)
        inf = g1.infinity((B * n,), dev)
        pts, _ = g1_glv_butterfly(inf, flat, _tiled(d1, B * n, dev),
                                  _tiled(d2, B * n, dev))
    return map_points(
        lambda c: c.reshape(batch_shape + (n, fp.N_WORDS)), pts)


def fft_g1(fs: FFTSettings, points: JacobianPoint,
           inverse: bool = False) -> JacobianPoint:
    """(I)FFT of (..., n) G1 points along the point axis; n a power of
    two <= fs.max_width (reference: fft_g1.go:62-68)."""
    n = points.x.shape[-2]
    if n > fs.max_width:
        raise ValueError("got more values than roots of unity")
    if n & (n - 1) != 0:
        raise ValueError("got a non-power-of-two number of values")
    if n == 1:
        return points
    inv_scale = pow(n, -1, fr.SPEC.modulus) if inverse else None
    return _fft_g1_core(points, fs.max_scale, inverse, inv_scale)


def reverse_bit_order_g1(points: JacobianPoint) -> JacobianPoint:
    """reference: reverseBitOrderG1 (fft_g1.go:97-107)."""
    return map_points(lambda c: brp_permute(c, axis=-2), points)
