"""The port's proof API on the kzg_env shape (width-32 domain, 17-point
CRS): KZGSettings.compute_proof_single (both methods) and
compute_proof_multi on tests/test_kzg.py's polynomial, and FK20 single
proofs (fk20/single.py) at FK20_N = 8, against the JAX package's outputs
recorded by make_reference.py (its MSMs and G1 FFTs compile for minutes
on the CPU) and proofs computed by definition. The port starts from the
JAX CRS and part-1 table (kzg_tpu_torch.convert). Points are compared in
affine form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    FK20_COEFFS,
    FK20_N,
    FK20_N2,
    MULTI_N,
    MULTI_X,
    PROOF_COEFFS,
    PROOF_X,
    TEST_SECRET,
    bitrev,
    eval_poly,
    ref_to_port,
    reference,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu.fk20.single import (
    toeplitz_coeffs_step as ref_toeplitz_coeffs_step,
)
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.fk20.single import FK20SingleSettings, toeplitz_coeffs_step
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
S = TEST_SECRET % R


def one(p: JacobianPoint) -> list:
    return g1.to_affine_ints(JacobianPoint(*(c[None] for c in p)))


def settings():
    return convert.kzg_settings_from_reference(
        FFTSettings(5, CPU), reference("crs", TEST_SECRET, CRS_SIZE))


def quotient_proof(coeffs, divisor) -> tuple:
    """[q(s)]G with q = coeffs div divisor, over Python ints."""
    rem, q = list(coeffs), [0] * (len(coeffs) - len(divisor) + 1)
    binv = pow(divisor[-1], -1, R)
    for pos in range(len(coeffs) - 1, len(divisor) - 2, -1):
        qi = rem[pos] * binv % R
        q[pos - len(divisor) + 1] = qi
        for j, d in enumerate(divisor):
            rem[pos - len(divisor) + 1 + j] -= qi * d
    return host_ec.g1_mul(host_ec.g1_generator(), eval_poly(q, S, R))


@pytest.mark.parametrize("method", ["auto", "serial"])
def test_proof_single_matches_reference(method):
    """The quotient on the evaluation domain ("auto": 17 is off the 16th
    roots of unity) and the synthetic division ("serial") give the same
    proof as the JAX package and [(p(x) - p(17)) / (x - 17)](s) G."""
    ks = settings()
    got = one(ks.compute_proof_single(fr.from_int(PROOF_COEFFS, CPU),
                                      PROOF_X, method=method))
    want = reference(f"proof_single:{method}", TEST_SECRET, CRS_SIZE,
                     jfr.from_int(PROOF_COEFFS), PROOF_X)
    assert got == one(ref_to_port(want))
    y = eval_poly(PROOF_COEFFS, PROOF_X, R)
    assert got == [quotient_proof([(PROOF_COEFFS[0] - y) % R]
                                  + PROOF_COEFFS[1:], [-PROOF_X % R, 1])]


def test_proof_multi_matches_reference():
    """The coset 5 <w_4>: [p / (x^4 - 5^4)](s) G."""
    ks = settings()
    got = one(ks.compute_proof_multi(fr.from_int(PROOF_COEFFS, CPU),
                                     MULTI_X, MULTI_N))
    want = reference("proof_multi", TEST_SECRET, CRS_SIZE,
                     jfr.from_int(PROOF_COEFFS), MULTI_X, MULTI_N)
    assert got == one(ref_to_port(want))
    divisor = [-pow(MULTI_X, MULTI_N, R) % R] + [0] * (MULTI_N - 1) + [1]
    assert got == [quotient_proof(PROOF_COEFFS, divisor)]
    with pytest.raises(ValueError):
        ks.compute_proof_multi(fr.from_int(PROOF_COEFFS, CPU), MULTI_X, 3)


def single_proofs_oracle(n_dom: int, rbo: bool) -> list:
    """FK20 single proofs by definition: proof i is
    [(p(x) - p(z)) / (x - z)](s) G at z = w^i of the n_dom-th roots (at
    w^bitrev(i) when `rbo`)."""
    w = pow(7, (R - 1) // n_dom, R)
    bits = (n_dom - 1).bit_length()
    out = []
    for i in range(n_dom):
        z = pow(w, bitrev(i, bits) if rbo else i, R)
        y = eval_poly(FK20_COEFFS, z, R)
        out.append(quotient_proof([(FK20_COEFFS[0] - y) % R]
                                  + FK20_COEFFS[1:], [-z % R, 1]))
    return out


@pytest.mark.parametrize("entry", ["settings", "fk20_single",
                                   "da_using_fk20"])
def test_fk20_single_matches_reference(entry):
    """settings: the port's own part-1 table xExtFFT equals the JAX one.
    fk20_single: the n = 8 proofs at the 8th roots of unity.
    da_using_fk20: the 16 proofs at the 16th roots in reverse-bit order,
    the reverse-bit permutation of fk20_single_da_optimized on the
    zero-extended polynomial. The proofs start from the JAX table."""
    fs = FFTSettings(5, CPU)
    tables = reference("fk20_single:tables", TEST_SECRET, CRS_SIZE, FK20_N2)
    fk = convert.fk20_single_settings_from_reference(
        fs, reference("crs", TEST_SECRET, CRS_SIZE), FK20_N2, tables)
    poly = fr.from_int(FK20_COEFFS, CPU)
    if entry == "settings":
        own = FK20SingleSettings(fk.ks, FK20_N2)
        assert g1.to_affine_ints(own.x_ext_fft) == \
            g1.to_affine_ints(ref_to_port(tables))
    elif entry == "fk20_single":
        got = g1.to_affine_ints(fk.fk20_single(poly))
        assert got == g1.to_affine_ints(ref_to_port(reference(
            "fk20_single:single", jfr.from_int(FK20_COEFFS))))
        assert got == single_proofs_oracle(FK20_N, rbo=False)
    else:
        got = g1.to_affine_ints(fk.da_using_fk20(poly))
        assert got == g1.to_affine_ints(ref_to_port(reference(
            "fk20_single:da", jfr.from_int(FK20_COEFFS))))
        ext = FK20_COEFFS + [0] * FK20_N
        opt = g1.to_affine_ints(ref_to_port(reference(
            "fk20_single:da_optimized", jfr.from_int(ext))))
        assert got == [opt[bitrev(i, 4)] for i in range(FK20_N2)]
        assert got == single_proofs_oracle(FK20_N2, rbo=True)


def test_fk20_single_settings_check_their_arguments():
    ks = settings()
    for n2 in (12, 1, 64, 32):       # not a power of two, too small,
        with pytest.raises(ValueError):   # wider than the domain or CRS
            FK20SingleSettings(ks, n2)
    tables = reference("fk20_single:tables", TEST_SECRET, CRS_SIZE, FK20_N2)
    with pytest.raises(ValueError):
        FK20SingleSettings.from_reference_arrays(ks, 8, ref_to_port(tables))
    fk = FK20SingleSettings.from_reference_arrays(ks, FK20_N2,
                                                  ref_to_port(tables))
    for call, n in ((fk.fk20_single, 16), (fk.da_using_fk20, 16),
                    (fk.fk20_single_da_optimized, 8)):
        with pytest.raises(ValueError):
            call(fr.zeros((n,), CPU))
    vals = list(range(1, FK20_N + 1))
    got = toeplitz_coeffs_step(fr.from_int(vals, CPU))
    want = ref_toeplitz_coeffs_step(jnp.asarray(jfr.from_int(vals)))
    assert torch.equal(got, convert.words_from_ref(np.asarray(want), CPU))
    assert [int(v) for v in fr.to_int(got)] == \
        [8] + [0] * 9 + list(range(2, 8))
