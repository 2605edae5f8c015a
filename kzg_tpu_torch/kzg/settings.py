"""KZG settings: the FFT domain and the G1 CRS [s^i]_1; commitments and
single and multi (coset) proofs.

A counterpart of kzg_tpu/kzg/settings.py for the prover's side: commit to
a polynomial in coefficient or evaluation form, and commit to the
quotients of single-point and coset proofs. Verification (the `check_*`
methods) and G2 come with a later slice.
"""

from __future__ import annotations

import functools

import torch

from .. import poly
from ..curve.msm import fixed_base_tables, lin_comb_fixed
from ..curve.weierstrass import JacobianPoint
from ..field import fr
from ..field.constants import FR_MODULUS
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import fft


class KZGSettings:
    def __init__(self, fs: FFTSettings, secret_g1: JacobianPoint):
        self.fs = fs
        self.secret_g1 = secret_g1

    @functools.cached_property
    def secret_g1_tables(self) -> torch.Tensor:
        """Fixed-base tables of the CRS, (N, 64, 8, 36) int32: entry m of
        window w of base i is (m+1) 16^w [s^i]_1. Built at the first
        commitment and kept (301,989,888 bytes at 4096 points)."""
        return fixed_base_tables(self.secret_g1)

    def commit_to_poly(self, coeffs) -> JacobianPoint:
        """MSM of the CRS against the coefficients (..., n, 8) (reference:
        CommitToPoly, kzg_single_proofs.go:17-20): one fixed-base product
        on the first n bases' tables and one row sum."""
        n = coeffs.shape[-2]
        if n > self.secret_g1.x.shape[0]:
            raise ValueError(f"{n} coefficients for a "
                             f"{self.secret_g1.x.shape[0]}-point CRS")
        return lin_comb_fixed(self.secret_g1_tables[:n], coeffs)

    def commit_to_eval_poly(self, evals) -> JacobianPoint:
        """Inverse FFT to coefficient form, then commit (reference:
        CommitToEvalPoly, kzg_single_proofs.go:12-15)."""
        return self.commit_to_poly(fft(self.fs, evals, inverse=True))

    def compute_proof_single(self, coeffs, x0: int,
                             method: str = "auto") -> JacobianPoint:
        """Commitment to q(x) = (p(x) - p(x0)) / (x - x0) (reference:
        ComputeProofSingle, kzg_single_proofs.go:36-54). coeffs (n, 8).

        method "auto" takes the parallel quotient on the evaluation domain
        when n is a power of two and x0 lies off the n-th roots of unity
        (the random-challenge case); otherwise, or with "serial", the
        synthetic division."""
        n = coeffs.shape[0]
        z = fr.from_int(x0 % FR_MODULUS, coeffs.device)
        pow2 = n & (n - 1) == 0
        in_domain = pow(x0 % FR_MODULUS, n, FR_MODULUS) == 1 if pow2 else True
        if method == "auto" and pow2 and not in_domain and n >= 2:
            return self.commit_to_poly(
                poly.poly_quotient_on_domain(self.fs, coeffs, z))
        return self.commit_to_poly(poly.poly_factor_div(coeffs, z))

    def compute_proof_multi(self, coeffs, x0: int, n: int) -> JacobianPoint:
        """Proof for p on the coset x0 * <w_n>: the commitment to
        q(x) = p(x) / (x^n - x0^n) (reference: ComputeProofMulti,
        kzg_multi_proofs.go:13-43)."""
        if n & (n - 1) != 0:
            raise ValueError("n must be a power of two")
        xn = pow(x0 % FR_MODULUS, n, FR_MODULUS)
        divisor = torch.cat((fr.from_int([-xn % FR_MODULUS], coeffs.device),
                             fr.zeros((n - 1,), coeffs.device),
                             fr.from_int([1], coeffs.device)))
        return self.commit_to_poly(poly.poly_long_div(coeffs, divisor))
