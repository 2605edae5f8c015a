"""The port's KZG checks against the JAX package on the same inputs: the
true and false flows of tests/test_kzg.py:40-73 (`check_proof_single`
on the host pairing, beside kzg_tpu's own check on the same affine
points; `check_proof_multi` beside kzg_tpu's recorded results), tampered
proofs, and `check_proof_multi_batch` on tests/test_pairing_device.py:
116-147's case (its plain versions on the CPU: K3, K-b, K-c), which must
give [True, True, False] as kzg_tpu's recorded batch does and agree with
the per-sample host checks; in its bilinear form it must give False
exactly on tampered cells, and the reference's verdict (its form on
kzg_tpu's host pairing) on lanes with pi or I - C - [x^l]pi at
infinity."""

import numpy as np
import pytest
import torch
from port_helpers import (
    BATCH_COEFFS,
    BATCH_M,
    BATCH_XS,
    CPU,
    CRS_SIZE,
    MULTI_N,
    MULTI_X,
    PROOF_COEFFS,
    PROOF_X,
    TEST_SECRET,
    batch_case,
    eval_poly,
    multi_case,
    reference,
)

from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.kzg.settings import KZGSettings
from kzg_tpu_torch.kzg.setup import generate_testing_setup
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus


def affine(p: JacobianPoint):
    return g1.to_affine_ints(JacobianPoint(*(c.reshape(-1, 12)
                                             for c in p)))[0]


@pytest.fixture(scope="module")
def ks() -> KZGSettings:
    """kzg_env's settings on the port: a width-32 domain, the 17-point
    CRS [s^i]_1 and [s^i]_2."""
    s1, _, _, s2 = generate_testing_setup(TEST_SECRET, CRS_SIZE, CPU)
    return KZGSettings(FFTSettings(5, CPU), s1, s2)


def test_check_proof_single_true_false(ks):
    from kzg_tpu.kzg import KZGSettings as RefSettings
    from kzg_tpu.kzg import generate_testing_setup as ref_setup
    from kzg_tpu.ntt import FFTSettings as RefFFT

    coeffs = fr.from_int(PROOF_COEFFS, CPU)
    commitment = ks.commit_to_poly(coeffs)
    proof = ks.compute_proof_single(coeffs, PROOF_X)
    y = eval_poly(PROOF_COEFFS, PROOF_X, R)
    wrong = host_ec.g1_add(affine(proof), host_ec.g1_generator())
    cases = [(proof, y), (proof, y + 1), (wrong, y)]
    got = [ks.check_proof_single(commitment, p, PROOF_X, v)
           for p, v in cases]
    assert got == [True, False, False]
    # kzg_tpu's host check on the same affine points (no compile)
    s1, _, a1, a2 = ref_setup(TEST_SECRET, CRS_SIZE)
    ref = RefSettings(RefFFT(5), s1, a2, a1)
    c = affine(commitment)
    assert got == [ref.check_proof_single(
        c, affine(p) if isinstance(p, JacobianPoint) else p, PROOF_X, v)
        for p, v in cases]


def test_check_proof_multi_true_false(ks):
    coeffs = fr.from_int(PROOF_COEFFS, CPU)
    commitment = ks.commit_to_poly(coeffs)
    proof = ks.compute_proof_multi(coeffs, MULTI_X, MULTI_N)
    got = [ks.check_proof_multi(commitment, proof, MULTI_X,
                                fr.from_int(ys, CPU))
           for ys in multi_case()]
    assert got == [True, False]
    want = reference("check_proof_multi", TEST_SECRET, CRS_SIZE,
                     PROOF_COEFFS, MULTI_X, MULTI_N, multi_case())
    assert got == want.tolist()
    # a proof of another coset fails
    other = ks.compute_proof_multi(coeffs, MULTI_X + 1, MULTI_N)
    assert not ks.check_proof_multi(commitment, other, MULTI_X,
                                    fr.from_int(multi_case()[0], CPU))


def test_check_proof_multi_batch(ks):
    coeffs = fr.from_int(BATCH_COEFFS, CPU)
    commitment = ks.commit_to_poly(coeffs)
    proofs = [ks.compute_proof_multi(coeffs, x, BATCH_M) for x in BATCH_XS]
    batch = JacobianPoint(*(torch.stack([p[i] for p in proofs])
                            for i in range(3)))
    rows = batch_case()
    ys = fr.from_int(rows, CPU)
    got = ks.check_proof_multi_batch(commitment, batch, BATCH_XS, ys)
    assert got == [True, True, False]
    want = reference("check_proof_multi_batch", TEST_SECRET, CRS_SIZE,
                     BATCH_COEFFS, BATCH_XS, rows)
    assert got == want.tolist()
    # parity with the per-sample host check
    assert [ks.check_proof_multi(commitment, proofs[i], x, ys[i])
            for i, x in enumerate(BATCH_XS)] == got


def test_settings_without_g2_refuse_checks():
    s1, _, _, _ = generate_testing_setup(TEST_SECRET, 4, CPU)
    prover = KZGSettings(FFTSettings(3, CPU), s1)
    with pytest.raises(ValueError, match="s\\^1"):
        prover.check_proof_single(None, None, 1, 1)


# degree 12: each coset's proof depends on its x (at degree < 2 l, the
# quotient by x^l - x0^l does not)
WIDE_COEFFS = BATCH_COEFFS + [5, 6, 11, 12, 13]


def batch_inputs(ks, coeffs_ints, xs):
    """The commitment, the coset proofs (all at infinity below degree l)
    and the true ys of each x."""
    coeffs = fr.from_int(coeffs_ints, CPU)
    commitment = ks.commit_to_poly(coeffs)
    if len(coeffs_ints) > BATCH_M:
        proofs = [ks.compute_proof_multi(coeffs, x, BATCH_M) for x in xs]
        batch = JacobianPoint(*(torch.stack([p[i] for p in proofs])
                                for i in range(3)))
    else:
        batch = g1.infinity((len(xs),), CPU)
    w = pow(7, (R - 1) // BATCH_M, R)
    ys = fr.from_int([[eval_poly(coeffs_ints, x * pow(w, i, R) % R, R)
                       for i in range(BATCH_M)] for x in xs], CPU)
    return commitment, batch, ys


def reference_verdict(ks, commitment, proof, x: int, ys_row) -> bool:
    """The reference's form on kzg_tpu's exact host pairing:
    e(I - C, G2) e(pi, [s^l - x^l]_2) == 1
    (kzg_tpu/kzg/settings.py:189-225)."""
    from kzg_tpu.curve import pairing as jpairing

    ip = affine(ks._interp_commit(ys_row[None],
                                  fr.from_int(pow(x, -1, R), CPU)))
    a1 = host_ec.g1_sub(ip, affine(commitment))
    g2x = host_ec.g2_mul(host_ec.g2_generator(), pow(x, BATCH_M, R))
    b2 = host_ec.g2_sub(ks._s2(BATCH_M), g2x)
    return jpairing.pairings_verify(a1, host_ec.g2_generator(), proof, b2)


def test_check_proof_multi_batch_tampered_cells(ks):
    """The bilinear form gives False exactly on the tampered cells: cell 1
    carries cell 3's proof, one value of cell 4 is off by one."""
    xs = BATCH_XS + [17, 19]
    commitment, batch, ys = batch_inputs(ks, WIDE_COEFFS, xs)
    assert ks.check_proof_multi_batch(commitment, batch, xs, ys) == \
        [True] * 5
    for c in batch:
        c[1] = c[3]
    ys[4, 2] = fr.add(ys[4, 2], fr.from_int(1, CPU))
    assert ks.check_proof_multi_batch(commitment, batch, xs, ys) == \
        [True, False, True, True, False]


def test_check_proof_multi_batch_points_at_infinity(ks):
    """Lane 1: pi at infinity; lane 2: pi = [x^-l](I - C), so that
    I - C - [x^l]pi is at infinity; each verdict is the reference's, in
    its form e(I - C, G2) e(pi, [s^l - x^l]_2) on the host. A polynomial
    of degree < l has I = C and every proof at infinity: all True."""
    xs = BATCH_XS
    commitment, batch, ys = batch_inputs(ks, WIDE_COEFFS, xs)
    for c in batch:
        c[1] = 0
    ip = affine(ks._interp_commit(ys[2:3], fr.from_int(pow(xs[2], -1, R),
                                                       CPU)))
    crafted = host_ec.g1_mul(host_ec.g1_sub(ip, affine(commitment)),
                             pow(pow(xs[2], BATCH_M, R), -1, R))
    for c, v in zip(batch, g1.from_affine_ints([crafted], CPU)):
        c[2] = v[0]
    got = ks.check_proof_multi_batch(commitment, batch, xs, ys)
    want = [reference_verdict(ks, commitment,
                              affine(JacobianPoint(*(c[i] for c in batch))),
                              x, ys[i]) for i, x in enumerate(xs)]
    assert got == want == [True, False, False]
    low = [3, 1, 4, 1]
    commitment, batch, ys = batch_inputs(ks, low, xs)
    got = ks.check_proof_multi_batch(commitment, batch, xs, ys)
    assert got == [reference_verdict(ks, commitment, None, x, ys[i])
                   for i, x in enumerate(xs)] == [True] * 3


@pytest.mark.parametrize("zero", [0, R, 2 * R])
def test_check_proof_multi_batch_zero_offset_raises(ks, zero):
    """An offset x = 0 mod r raises ValueError in both packages, before
    anything touches the points or the values: kzg_tpu inverts each x on
    the host (kzg_tpu/kzg/settings.py:206), the port checks for 0 first
    (fr_batch_inv would map it to 0 and the check would go on)."""
    from kzg_tpu.kzg import KZGSettings as RefSettings
    from kzg_tpu.kzg import generate_testing_setup as ref_setup
    from kzg_tpu.ntt import FFTSettings as RefFFT

    xs = [BATCH_XS[0], zero, BATCH_XS[2]]
    ys = fr.from_int(batch_case(), CPU)
    with pytest.raises(ValueError):
        ks.check_proof_multi_batch(None, None, xs, ys)
    s1, _, a1, a2 = ref_setup(TEST_SECRET, CRS_SIZE)
    ref = RefSettings(RefFFT(5), s1, a2, a1)
    with pytest.raises(ValueError):
        ref.check_proof_multi_batch(None, None, xs,
                                    np.zeros((3, BATCH_M, 16), np.uint32))
