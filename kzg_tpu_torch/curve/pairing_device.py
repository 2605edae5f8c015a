"""The batched pairing check on the card (kzg_tpu/curve/pairing_device.py):
N lanes of e(a1, a2) e(b1, b2) == 1 on K-b (`pairing_lines`, the G2 half
of the Miller loop, and `pairing_miller_eval`, its evaluation at the G1
points) and the final exponentiation with its is-one flag (K-c,
`pairing_final_exp`), all in curve/pairing_kernels.py.

Values are Montgomery words; an Fp12 is (..., 2, 3, 2, 12) in the tower of
curve/pairing.py. The Miller values are the kernel's (on the twist, with
line factors in proper subfields), not the reference's: only their final
exponentiations compare.
"""

from __future__ import annotations

from .pairing_kernels import (pairing_final_exp, pairing_miller,
                              pairing_miller_eval)
from .weierstrass import JacobianPoint


def product_is_one_on_lines(a1: JacobianPoint, a_lines, a2inf,
                            b1: JacobianPoint, b_lines, b2inf):
    """Batched e(a1_i, a2_i) e(b1_i, b2_i) == 1 -> bool (N,) from the G2
    points' lines (pairing_lines: (N or 1, N_LINES, 3, 2, 12), one set for
    all lanes where a G2 point is fixed) and their bool infinity flags
    (N,): two launches."""
    f = pairing_miller_eval(a1, a_lines, a2inf, b1, b_lines, b2inf)
    return pairing_final_exp(f)[1]


def pairings_product_is_one(a1: JacobianPoint, a2_affine,
                            b1: JacobianPoint, b2_affine):
    """Batched e(a1_i, a2_i) e(b1_i, b2_i) == 1 -> bool (N,).

    a1, b1: G1 Jacobian batches (N,); a2_affine, b2_affine: G2 affine
    (x, y, is_infinity) with Fp2 coordinates (N, 2, 12) (g2.to_affine). A
    pair with a G1 or G2 point at infinity contributes 1 (PairingsVerify
    parity: kilic skips such terms; kzg_tpu/curve/pairing_device.py:
    325-358). The lines of all 2N G2 points take one launch."""
    return pairing_final_exp(pairing_miller(a1, *a2_affine, b1,
                                            *b2_affine))[1]
