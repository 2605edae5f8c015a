"""KZG settings: the FFT domain, the G1 CRS [s^i]_1 and [s^i]_2;
commitments, single and multi (coset) proofs, and their checks
(kzg_tpu/kzg/settings.py).

Commitments, quotients and interpolation commitments are device work. The
checks of one sample (`check_proof_single`, `check_proof_multi`) end in
one pairing product on the host's native library
(curve/pairing_native.py), as in the reference. `check_proof_multi_batch`
checks N coset samples on the card in the bilinear form
e(I_i - C - [x_i^l]pi_i, G2) e(pi_i, [s^l]_2) == 1: their interpolation
commitments as one batched fixed-base MSM, [x_i^l]pi_i on K3, the N
pairing products on K-b's evaluation and K-c, on the lines of G2 and
[s^l]_2 that the settings compute once (K-b's lines part) and keep.
"""

from __future__ import annotations

import functools

import torch

from .. import poly
from ..curve import fp2, g1, pairing, pairing_device
from ..curve.msm import fixed_base_tables, lin_comb_fixed
from ..curve.pairing_kernels import pairing_lines
from ..curve.weierstrass import JacobianPoint
from ..field import fp, fr
from ..field.constants import FP_MODULUS, FR_MODULUS
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import fft
from ..utils import host_ec


def _as_affine_g1(pt):
    """A device JacobianPoint (one point, coords (12,)) or a host affine
    tuple / None -> host affine (the one inverse on the host)."""
    if not isinstance(pt, JacobianPoint):
        return pt
    x, y, z = (int(fp.to_int(c.reshape(-1, fp.N_WORDS))[0]) for c in pt)
    if z == 0:
        return None
    zi = pow(z, -1, FP_MODULUS)
    return (x * zi * zi % FP_MODULUS, y * pow(zi, 3, FP_MODULUS) % FP_MODULUS)


class KZGSettings:
    def __init__(self, fs: FFTSettings, secret_g1: JacobianPoint,
                 secret_g2_affine=None):
        """secret_g1: (n,) G1 batch on fs.device; secret_g2_affine: host
        list of [s^i]_2 as affine Fp2 pairs, None where not computed (the
        checks read index 1 and the coset width), or None for a prover's
        settings."""
        self.fs = fs
        self.secret_g1 = secret_g1
        self.secret_g2_affine = (None if secret_g2_affine is None
                                 else list(secret_g2_affine))
        self._g2_lines = {}

    def _s2(self, i: int):
        if self.secret_g2_affine is None or \
                i >= len(self.secret_g2_affine) or \
                self.secret_g2_affine[i] is None:
            raise ValueError(f"these settings hold no [s^{i}]_2")
        return self.secret_g2_affine[i]

    def g2_lines(self, l: int, device) -> torch.Tensor:
        """The Miller loop's lines of G2 and [s^l]_2 (K-b's lines part, one
        launch at the first call for this l and device, then kept):
        (2, N_LINES, 3, 2, 12) words, 39,168 bytes."""
        key = (l, str(device))
        if key not in self._g2_lines:
            pts = [host_ec.g2_generator(), self._s2(l)]
            self._g2_lines[key] = pairing_lines(
                fp2.from_int([q[0] for q in pts], device),
                fp2.from_int([q[1] for q in pts], device))
        return self._g2_lines[key]

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

    def check_proof_single(self, commitment, proof, x: int, y: int) -> bool:
        """e(proof, [s - x]_2) == e(commitment - [y]_1, G2) on the host
        pairing (reference: CheckProofSingle, kzg_single_proofs.go:57-75).
        Points: device JacobianPoints of one point, or affine ints."""
        x2 = host_ec.g2_mul(host_ec.g2_generator(), x % FR_MODULUS)
        xn2 = host_ec.g2_sub(self._s2(1), x2)              # [s - x]_2
        y1 = host_ec.g1_mul(host_ec.g1_generator(), y % FR_MODULUS)
        cm = host_ec.g1_sub(_as_affine_g1(commitment), y1)
        return pairing.pairings_verify(host_ec.g1_neg(cm),
                                       host_ec.g2_generator(),
                                       _as_affine_g1(proof), xn2)

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

    def _interp_commit(self, ys, xinv) -> JacobianPoint:
        """[I(s)]_1 for the polynomial I with I(x w^j) = ys[..., j, :]:
        the inverse FFT (fr_fft_block), the scale by x^-j, and the
        fixed-base MSM on the CRS tables (fr_signed_windows,
        g1_fixed_base_mul, g1_sum). ys (..., n, 8), xinv (..., 8)."""
        n = ys.shape[-2]
        coeffs = fr.mul(fft(self.fs, ys, inverse=True),
                        poly.powers_of(xinv, n))
        return self.commit_to_poly(coeffs)

    def check_proof_multi(self, commitment, proof, x: int, ys) -> bool:
        """p(x w^i) == ys[i] for all i, in one host pairing product
        (reference: CheckProofMulti, kzg_multi_proofs.go:47-88). ys: (n, 8)
        claimed evaluations on the coset, in the domain's natural order."""
        n = ys.shape[0]
        xinv = pow(x % FR_MODULUS, -1, FR_MODULUS)
        is1 = self._interp_commit(ys, fr.from_int(xinv, ys.device))
        xn2 = host_ec.g2_mul(host_ec.g2_generator(),
                             pow(x % FR_MODULUS, n, FR_MODULUS))
        xn_minus = host_ec.g2_sub(self._s2(n), xn2)       # [s^n - x^n]_2
        cm = host_ec.g1_sub(_as_affine_g1(commitment), _as_affine_g1(is1))
        return pairing.pairings_verify(host_ec.g1_neg(cm),
                                       host_ec.g2_generator(),
                                       _as_affine_g1(proof), xn_minus)

    def check_proof_multi_batch(self, commitment, proofs, xs, ys) -> list:
        """N coset proofs checked at once on the card: for each sample i,
        p(x_i w^j) == ys[i, j] for all j (the reference loops
        CheckProofMulti, kzg_multi_proofs.go:47-88; kzg_tpu/kzg/settings.py
        :189-225). commitment: one device point; proofs: (N,) G1 batch;
        xs: N host ints; ys: (N, l, 8), each row in its coset's natural
        order. Returns [bool] * N.

        On the card, in the bilinear form of c-kzg-4844's
        verify_cell_kzg_proof_batch: e(I_i - C, G2) e(pi_i, [s^l - x_i^l]_2)
        is e(I_i - C - [x_i^l]pi_i, G2) e(pi_i, [s^l]_2), the same element
        of GT, so each lane's verdict is the reference's (a point at
        infinity contributes 1 on both sides). The N inverse FFTs
        (fr_fft_block), x_i^-1 (fr_batch_inv) and its powers (K1), the N
        interpolation commitments as one batched fixed-base MSM, x_i^l
        (fr_pow), [x_i^l]pi_i (fr_signed_windows, K3), a1 = I_i - C -
        [x_i^l]pi_i (two g1_add), then K-b's evaluation on the cached lines
        of G2 and [s^l]_2 (every lane reads the same) and K-c."""
        n_samples, l = ys.shape[0], ys.shape[1]
        if len(xs) != n_samples:
            raise ValueError("xs/ys length mismatch")
        xs = [int(v) % FR_MODULUS for v in xs]
        if 0 in xs:
            # the reference inverts each offset on the host, where 0 raises
            # before any device work (kzg_tpu/kzg/settings.py:206);
            # fr_batch_inv would map it to 0 and the check would go on
            raise ValueError("a coset offset is 0 mod r: it has no inverse")
        dev = ys.device
        x = fr.from_int(xs, dev)
        is1 = self._interp_commit(ys, fr.batch_inv(x))            # (N,)
        c = JacobianPoint(*(t.reshape(1, 12).expand(n_samples, 12)
                            for t in commitment))
        xpi = g1.mul(proofs, fr.pow_static(x, l))                 # [x^l]pi
        a1 = g1.ops_kernel.sub(g1.ops_kernel.sub(is1, c), xpi)
        lines = self.g2_lines(l, dev)
        finite = torch.zeros((n_samples,), dtype=torch.bool, device=dev)
        ok = pairing_device.product_is_one_on_lines(
            a1, lines[:1], finite, proofs, lines[1:], finite)
        return [bool(v) for v in ok.cpu()]
