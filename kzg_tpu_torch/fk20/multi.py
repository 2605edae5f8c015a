"""FK20 multi (coset) proofs: k = n/l proofs, each for an l-point coset,
in O(n log n) (reference: fk20_multi.go:25-133, kzg.go:66-116).

The polynomial splits into l strided sub-polynomials; each contributes a
Toeplitz product against its own strided CRS slice, and the l products
sum into one hExtFFT. All l are batched: one Fr FFT launch per stage, one
fixed-base launch for the pointwise products (on tables built with the
settings), one `g1_sum` launch for the l-way sum, then the G1 FFTs (one
dense stage each at 2k <= 128 points). The per-offset part-1 tables are
also built as one batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curve import g1
from ..curve.fft_g1 import fft_g1, reverse_bit_order_g1
from ..curve.kernels import g1_sum
from ..curve.msm import fixed_base_tables
from ..curve.weierstrass import JacobianPoint
from ..field import fr
from ..kzg.settings import KZGSettings
from .toeplitz import (
    concat_points,
    toeplitz_part1,
    toeplitz_part2,
    toeplitz_part3,
)


def toeplitz_coeffs_step_strided(poly, offset: int, stride: int):
    """Strided circulant vector (reference: toeplitzCoeffsStepStrided,
    fk20_single.go:89-119): for sub[m] = f_{offset + m*stride},
        [sub_{k-1}, 0 x (k+1), sub_1, ..., sub_{k-2}]   (length 2k)
    """
    k = poly.shape[0] // stride
    sub = poly[offset::stride]
    return torch.cat((sub[k - 1: k], fr.zeros((k + 1,), poly.device),
                      sub[1: k - 1]))


def crs_indices(n: int, l: int) -> np.ndarray:
    """(l, k-1) CRS rows: offset i takes s^{(k-2)l+i}, ..., s^{l+i}, s^i
    (the block-quotient identity h_m^(i) = sum_c f_{(c+m+1)l+i} s^{cl+i})."""
    return np.stack([np.arange(n - 2 * l + i, i - 1, -l) for i in range(l)])


class FK20MultiSettings:
    """The l per-offset xExtFFT tables, (l, 2k) points
    (reference: NewFK20MultiSettings, kzg.go:73-116), and their fixed-base
    tables for part 2, (l, 2k, 64, 8, 36) words. n2 = 2n is the extended
    width; chunk_len = l the coset size."""

    def __init__(self, ks: KZGSettings, n2: int, chunk_len: int,
                 x_ext_fft_files: JacobianPoint | None = None):
        if n2 & (n2 - 1) != 0 or n2 < 2:
            raise ValueError("n2 must be a power of two >= 2")
        if n2 > ks.fs.max_width:
            raise ValueError("n2 too large for the FFT settings")
        if chunk_len & (chunk_len - 1) != 0 or chunk_len < 1:
            raise ValueError("chunk_len must be a power of two >= 1")
        if chunk_len >= n2 // 2:
            raise ValueError("chunk_len too large")
        self.ks = ks
        self.n2 = n2
        self.chunk_len = chunk_len
        self.n = n2 // 2
        self.k = self.n // chunk_len
        if x_ext_fft_files is None:
            idx = torch.as_tensor(crs_indices(self.n, chunk_len),
                                  device=ks.fs.device)
            x = JacobianPoint(*(c[idx] for c in ks.secret_g1))  # (l, k-1)
            inf = g1.infinity((chunk_len, 1), ks.fs.device)
            x_ext_fft_files = toeplitz_part1(ks.fs, concat_points(x, inf))
        self.x_ext_fft_files = x_ext_fft_files
        self._block_tables = {}

    @classmethod
    def from_reference_arrays(cls, ks: KZGSettings, n2: int, chunk_len: int,
                              x_ext_fft_files: JacobianPoint):
        """Settings from precomputed (l, 2k) tables (see
        kzg_tpu_torch.convert.fk20_settings_from_reference)."""
        expect = (chunk_len, n2 // chunk_len)
        if tuple(x_ext_fft_files.x.shape[:-1]) != expect:
            raise ValueError(f"tables must be {expect} points")
        return cls(ks, n2, chunk_len, x_ext_fft_files)

    @functools.cached_property
    def x_ext_fft_tables(self) -> torch.Tensor:
        """Fixed-base tables of the part-1 points for part 2, built on the
        card at first use and kept (604 MB at 8192 points)."""
        return fixed_base_tables(self.x_ext_fft_files)

    def block_tables(self, start: int, stop: int) -> torch.Tensor:
        """Fixed-base tables of the part-1 points [:, start:stop] only,
        (l, stop - start, 64, 8, 36): a rank's block of the 2k axis in the
        sharded pipeline. Built at first use and kept per block."""
        if (start, stop) not in self._block_tables:
            self._block_tables[start, stop] = fixed_base_tables(JacobianPoint(
                *(c[:, start:stop] for c in self.x_ext_fft_files)))
        return self._block_tables[start, stop]

    def _h_from_reduced(self, reduced) -> JacobianPoint:
        """reduced (n, 8) -> h, (k,) points."""
        l = self.chunk_len
        tcs = torch.stack([toeplitz_coeffs_step_strided(reduced, i, l)
                           for i in range(l)])              # (l, 2k, 8)
        h_ext_fft = g1_sum(
            toeplitz_part2(self.ks.fs, tcs, self.x_ext_fft_tables), dim=0)
        return toeplitz_part3(self.ks.fs, h_ext_fft)

    def fk20_multi(self, poly) -> JacobianPoint:
        """k proofs for the k cosets of the n-domain, natural order
        (reference: FK20Multi, fk20_multi.go:25-54). poly: (n, 8)."""
        if poly.shape[0] != self.n:
            raise ValueError(f"expected polynomial of length {self.n}")
        return fft_g1(self.ks.fs, self._h_from_reduced(poly))

    def fk20_multi_da_optimized(self, poly) -> JacobianPoint:
        """2k proofs for an extended polynomial with zero top half
        (reference: FK20MultiDAOptimized, fk20_multi.go:58-109).
        poly: (2n, 8)."""
        if poly.shape[0] != self.n2:
            raise ValueError(f"expected polynomial of length {self.n2}")
        h = self._h_from_reduced(poly[: self.n])
        h_ext = concat_points(h, g1.infinity((self.k,), poly.device))
        return fft_g1(self.ks.fs, h_ext)

    def da_using_fk20_multi(self, poly) -> JacobianPoint:
        """Extend to 2n and return the 2k coset proofs in reverse-bit
        order (reference: DAUsingFK20Multi, fk20_multi.go:113-133)."""
        if poly.shape[0] != self.n:
            raise ValueError(f"expected polynomial of length {self.n}")
        ext = torch.cat((poly, fr.zeros((self.n,), poly.device)))
        return reverse_bit_order_g1(self.fk20_multi_da_optimized(ext))
