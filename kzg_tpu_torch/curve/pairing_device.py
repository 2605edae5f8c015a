"""The batched pairing check on the card (kzg_tpu/curve/pairing_device.py):
N lanes of e(a1, a2) e(b1, b2) == 1 in two launches, the two-pair Miller
loop (K-b, `pairing_miller`) and the final exponentiation with its is-one
flag (K-c, `pairing_final_exp`), both in curve/pairing_kernels.py.

Values are Montgomery words; an Fp12 is (..., 2, 3, 2, 12) in the tower of
curve/pairing.py. The Miller values are the kernel's (on the twist, with
line factors in proper subfields), not the reference's: only their final
exponentiations compare.
"""

from __future__ import annotations

from .pairing_kernels import pairing_final_exp, pairing_miller
from .weierstrass import JacobianPoint


def pairings_product_is_one(a1: JacobianPoint, a2_affine,
                            b1: JacobianPoint, b2_affine):
    """Batched e(a1_i, a2_i) e(b1_i, b2_i) == 1 -> bool (N,).

    a1, b1: G1 Jacobian batches (N,); a2_affine, b2_affine: G2 affine
    (x, y, is_infinity) with Fp2 coordinates (N, 2, 12) (g2.to_affine). A
    pair with a G1 or G2 point at infinity contributes 1 (PairingsVerify
    parity: kilic skips such terms; kzg_tpu/curve/pairing_device.py:
    325-358)."""
    f = pairing_miller(a1, *a2_affine, b1, *b2_affine)
    return pairing_final_exp(f)[1]

