"""FK20 single-point proofs: all n KZG proofs in O(n log n)
(kzg_tpu/fk20/single.py; reference: fk20_single.go:122-196,
NewFK20SingleSettings, kzg.go:38-64).

The proofs pi_i = [q_{w^i}(s)]_1 are the G1 FFT of h = T(f) x with
x = [s^{n-2}, ..., s^1, s^0, O] and T(f) the Toeplitz matrix of the
coefficients, computed by circulant embedding (toeplitz.py): one Fr FFT,
one fixed-base product on the settings' tables, then G1 FFTs. The DA-optimized variant uses the zero
top half of an extended polynomial, so the Toeplitz work stays n wide for
2n proofs.
"""

from __future__ import annotations

import functools

import torch

from ..curve import g1
from ..curve.fft_g1 import fft_g1, reverse_bit_order_g1
from ..curve.msm import fixed_base_tables
from ..curve.weierstrass import JacobianPoint, map_points
from ..field import fr
from ..kzg.settings import KZGSettings
from .toeplitz import concat_points, toeplitz_part1, toeplitz_part2, \
    toeplitz_part3


def toeplitz_coeffs_step(poly):
    """Circulant first column (reference: toeplitzCoeffsStep,
    fk20_single.go:89-103): [f_{n-1}, 0 x (n+1), f_1, ..., f_{n-2}],
    length 2n."""
    n = poly.shape[0]
    return torch.cat((poly[n - 1:n], fr.zeros((n + 1,), poly.device),
                      poly[1:n - 1]))


class FK20SingleSettings:
    """xExtFFT = FFT_G1([x; 0]), (2n,) points, for n2 = 2n (reference:
    NewFK20SingleSettings, kzg.go:43-64), and its fixed-base tables,
    (2n, 64, 8, 36) words."""

    def __init__(self, ks: KZGSettings, n2: int,
                 x_ext_fft: JacobianPoint | None = None):
        if n2 & (n2 - 1) != 0 or n2 < 2:
            raise ValueError("n2 must be a power of two >= 2")
        if n2 > ks.fs.max_width:
            raise ValueError("n2 too large for the FFT settings")
        if ks.secret_g1.x.shape[0] < n2:
            raise ValueError("CRS shorter than n2")
        self.ks = ks
        self.n = n2 // 2
        self.n2 = n2
        if x_ext_fft is None:
            idx = torch.arange(self.n - 2, -1, -1, device=ks.fs.device)
            x = concat_points(map_points(lambda c: c[idx], ks.secret_g1),
                              g1.infinity((1,), ks.fs.device))
            x_ext_fft = toeplitz_part1(ks.fs, x)
        self.x_ext_fft = x_ext_fft

    @classmethod
    def from_reference_arrays(cls, ks: KZGSettings, n2: int,
                              x_ext_fft: JacobianPoint):
        """Settings from a precomputed (n2,) table (see
        kzg_tpu_torch.convert.fk20_single_settings_from_reference)."""
        if tuple(x_ext_fft.x.shape[:-1]) != (n2,):
            raise ValueError(f"the table must be {n2} points")
        return cls(ks, n2, x_ext_fft)

    @functools.cached_property
    def x_ext_fft_tables(self) -> torch.Tensor:
        """Fixed-base tables of the part-1 points for part 2, built on the
        card at first use and kept (604 MB at 8192 points)."""
        return fixed_base_tables(self.x_ext_fft)

    def _h(self, poly) -> JacobianPoint:
        """poly (n, 8) -> h, (n,) points."""
        fs = self.ks.fs
        return toeplitz_part3(fs, toeplitz_part2(
            fs, toeplitz_coeffs_step(poly), self.x_ext_fft_tables))

    def fk20_single(self, poly) -> JacobianPoint:
        """All n proofs for p at the n-th roots of unity, natural order
        (reference: FK20Single, fk20_single.go:122-137). poly (n, 8)."""
        if poly.shape[0] != self.n:
            raise ValueError(f"expected polynomial of length {self.n}")
        return fft_g1(self.ks.fs, self._h(poly))

    def fk20_single_da_optimized(self, poly) -> JacobianPoint:
        """All 2n proofs for an extended polynomial whose top n
        coefficients are zero (reference: FK20SingleDAOptimized,
        fk20_single.go:139-173). poly (2n, 8)."""
        if poly.shape[0] != self.n2:
            raise ValueError(f"expected polynomial of length {self.n2}")
        h = self._h(poly[:self.n])
        return fft_g1(self.ks.fs, concat_points(
            h, g1.infinity((self.n,), poly.device)))

    def da_using_fk20(self, poly) -> JacobianPoint:
        """Extend an n-polynomial to 2n and return the 2n proofs in
        reverse-bit order, the data-availability layout (reference:
        DAUsingFK20, fk20_single.go:176-196)."""
        if poly.shape[0] != self.n:
            raise ValueError(f"expected polynomial of length {self.n}")
        ext = torch.cat((poly, fr.zeros((self.n,), poly.device)))
        return reverse_bit_order_g1(self.fk20_single_da_optimized(ext))
