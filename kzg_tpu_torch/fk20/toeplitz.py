"""Toeplitz matrix-by-CRS-vector products in Fourier space, the FK20
core (reference: toeplitzPart1/2/3, fk20_single.go:40-87):
    T x = IFFT_G1( FFT_Fr(c) o FFT_G1([x; 0]) )[:n]
Part 1 is a precompute, and with it the fixed-base tables of its points
(`curve.msm.fixed_base_tables`);
part 2 one batched fixed-base product (`g1_fixed_base_mul`, no doubling),
part 3 one inverse G1 FFT. Every part takes leading batch axes.
"""

from __future__ import annotations

import torch

from ..curve import g1
from ..curve.fft_g1 import fft_g1
from ..curve.kernels import FIXED_WINDOWS, g1_fixed_base_mul
from ..curve.weierstrass import JacobianPoint, map_points
from ..field import fp, fr
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import fft


def take_points(p: JacobianPoint, idx) -> JacobianPoint:
    """The points at `idx` along the leading batch axis."""
    idx = torch.as_tensor(idx, device=p.x.device).long()
    return map_points(lambda c: c[idx], p)


def concat_points(*ps: JacobianPoint) -> JacobianPoint:
    return map_points(lambda *cs: torch.cat(cs, dim=-2), *ps)


def toeplitz_part1(fs: FFTSettings, x: JacobianPoint) -> JacobianPoint:
    """Zero-extend (..., n) CRS points to 2n and G1-FFT them."""
    n = x.x.shape[-2]
    inf = g1.infinity(tuple(x.x.shape[:-2]) + (n,), x.x.device)
    return fft_g1(fs, concat_points(x, inf))


def toeplitz_part2(fs: FFTSettings, toeplitz_coeffs,
                   x_ext_fft_tables: torch.Tensor) -> JacobianPoint:
    """hExtFFT[i] = FFT(toeplitz_coeffs)[i] * xExtFFT[i]; coeffs
    (..., 2k, 8) against the (..., 2k) points' fixed-base tables: one
    batched g1_fixed_base_mul launch."""
    return fixed_base_products(fft(fs, toeplitz_coeffs), x_ext_fft_tables)


def fixed_base_products(scalars, tables: torch.Tensor) -> JacobianPoint:
    """scalars[..., i] * B_i: Montgomery scalars (..., m, 8) against the
    fixed-base tables (..., m, 64, 8, 36) of their points, one digit
    recoding and one g1_fixed_base_mul launch."""
    digits = fr.scalar_windows_signed(scalars)
    shape = tuple(digits.shape[:-1])
    tables = tables.reshape((-1,) + tables.shape[-3:])
    if tables.shape[0] != digits[..., 0].numel():
        raise ValueError("toeplitz_part2: one table per coefficient")
    out = g1_fixed_base_mul(tables, digits.reshape(-1, FIXED_WINDOWS)
                            .contiguous())
    return map_points(lambda c: c.reshape(shape + (fp.N_WORDS,)), out)


def toeplitz_part3(fs: FFTSettings, h_ext_fft: JacobianPoint) -> JacobianPoint:
    """Inverse G1-FFT and keep the first half."""
    n2 = h_ext_fft.x.shape[-2]
    h = fft_g1(fs, h_ext_fft, inverse=True)
    return map_points(lambda c: c[..., : n2 // 2, :], h)
