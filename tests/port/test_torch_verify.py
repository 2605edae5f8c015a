"""The port's KZG checks against the JAX package on the same inputs: the
true and false flows of tests/test_kzg.py:40-73 (`check_proof_single`
on the host pairing, beside kzg_tpu's own check on the same affine
points; `check_proof_multi` beside kzg_tpu's recorded results), tampered
proofs, and `check_proof_multi_batch` on tests/test_pairing_device.py:
116-147's case (its plain versions on the CPU: K-a, K-b, K-c), which must
give [True, True, False] as kzg_tpu's recorded batch does and agree with
the per-sample host checks."""

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
