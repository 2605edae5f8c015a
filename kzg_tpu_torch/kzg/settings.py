"""KZG settings: the FFT domain and the G1 CRS [s^i]_1, and commitments.

A counterpart of kzg_tpu/kzg/settings.py for the producer side: commit to
a polynomial in coefficient or evaluation form. Proofs other than FK20's,
verification and G2 come with later slices.
"""

from __future__ import annotations

from ..curve.msm import lin_comb_g1
from ..curve.weierstrass import JacobianPoint, map_points
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import fft


class KZGSettings:
    def __init__(self, fs: FFTSettings, secret_g1: JacobianPoint):
        self.fs = fs
        self.secret_g1 = secret_g1

    def commit_to_poly(self, coeffs) -> JacobianPoint:
        """MSM of the CRS against the coefficients (..., n, 8) (reference:
        CommitToPoly, kzg_single_proofs.go:17-20)."""
        n = coeffs.shape[-2]
        if n > self.secret_g1.x.shape[0]:
            raise ValueError(f"{n} coefficients for a "
                             f"{self.secret_g1.x.shape[0]}-point CRS")
        return lin_comb_g1(map_points(lambda c: c[:n], self.secret_g1),
                           coeffs)

    def commit_to_eval_poly(self, evals) -> JacobianPoint:
        """Inverse FFT to coefficient form, then commit (reference:
        CommitToEvalPoly, kzg_single_proofs.go:12-15)."""
        return self.commit_to_poly(fft(self.fs, evals, inverse=True))
