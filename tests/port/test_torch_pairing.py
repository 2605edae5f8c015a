"""The port's pairing against the JAX package and the exact host tower:
the plain Fp12 tower (curve/tower.py) against kzg_tpu.curve.pairing,
the Frobenius gammas against kzg_tpu's derivation, K-c
(`pairing_final_exp`)'s plain version against the recorded
kzg_tpu pairing_device.final_exponentiation and the host's, K-b
(`pairing_miller`)'s plain version followed by K-c against the recorded
Miller loop + final exponentiation and against pairing(P, Q), the batched
product check with an infinity lane and a corrupted lane, and the native
host pairing against the Python one. Exact: canonical words and ints.

The plain Fp12 chains cost about a second a call: the Miller loops and
final exponentiations here run on 2-3 lanes, a handful of calls."""

import pytest
import torch
from port_helpers import (
    CPU,
    FEXP_LANES,
    miller_case,
    random_f12_ints,
    reference,
)

from kzg_tpu.curve import pairing as jpairing
from kzg_tpu.curve import tower as jtower
from kzg_tpu.curve.pairing_device import _frob_gammas
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import fp2, g1, pairing, pairing_device
from kzg_tpu_torch.curve import pairing_kernels as pk
from kzg_tpu_torch.curve import tower
from kzg_tpu_torch.field.constants import FP_MODULUS
from kzg_tpu_torch.utils import host_ec

G1 = host_ec.g1_generator()
G2 = host_ec.g2_generator()


def to_jf12(x) -> "jpairing.F12":
    """Nested ints [w][v][u] -> kzg_tpu's exact F12."""
    F2, F6 = jpairing.F2, jpairing.F6
    return jpairing.F12(*(F6(*(F2(*c) for c in s)) for s in x))


def words(vals) -> torch.Tensor:
    """kzg_tpu F12 objects -> port words (n, 2, 3, 2, 12), by value."""
    return torch.stack([tower.f12_from_int(pairing.F12(*(
        pairing.F6(*(pairing.F2(c.a, c.b) for c in (s.c0, s.c1, s.c2)))
        for s in (v.c0, v.c1))), CPU) for v in vals])


def as_ref(x: "pairing.F12") -> "jpairing.F12":
    F2, F6 = jpairing.F2, jpairing.F6
    return jpairing.F12(*(F6(*(F2(c.a, c.b) for c in (s.c0, s.c1, s.c2)))
                          for s in (x.c0, x.c1)))


def lazy(w):
    return tower.from_words(w)


def test_tower_matches_host_oracle():
    a, b = (to_jf12(v) for v in random_f12_ints(140, 2))
    wa, wb = words([a]), words([b])
    la, lb = lazy(wa), lazy(wb)

    def back(v):
        return as_ref(tower.f12_to_oracle(tower.to_words(v))[0])

    assert back(tower.f12_mul(la, lb)) == a * b
    assert back(tower.f12_sqr(la)) == a * a
    assert back(tower.f12_inv(la)) == a.inv()
    assert back(tower.f12_conj(la)) == a.conj()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_frobenius_gammas_match_reference(k):
    """The gammas xi^(e (p^k - 1)/6) equal kzg_tpu's, read off
    basis^(p^k) in its exact tower; the map equals f^(p^k)."""
    want = convert.words_from_ref(_frob_gammas(k), CPU)
    assert torch.equal(pk.frobenius_gammas(CPU)[k - 1], want)
    a = to_jf12(random_f12_ints(141, 1)[0])
    g = tower.from_words(pk.frobenius_gammas(CPU)[k - 1])
    got = tower.to_words(tower.frobenius(tower.from_words(words([a])), g,
                                         k % 2 == 1))
    assert as_ref(tower.f12_to_oracle(got)[0]) == a.pow(FP_MODULUS ** k)


def test_final_exp_plain_matches_recorded_and_host():
    vals = random_f12_ints(130, FEXP_LANES)
    f = words([to_jf12(v) for v in vals])
    out, ok = pk.pairing_final_exp(f)              # plain on the CPU
    want = reference("final_exp", jtower.f12_from_int(
        [to_jf12(v) for v in vals]))
    assert torch.equal(out, convert.words_from_ref(want, CPU))
    assert not ok.any()
    host = pairing.final_exponentiation(tower.f12_to_oracle(f[:1])[0])
    assert tower.f12_to_oracle(out[:1])[0] == host


def test_miller_plain_then_final_exp_matches_reference():
    """K-b's plain version (one pair a lane, the other at infinity), then
    K-c's, against the recorded untwisted Miller loop + final
    exponentiation and against pairing.pairing(P, Q)."""
    case = miller_case()
    p = g1.from_affine_ints([c[0] for c in case], CPU)
    qx = fp2.from_int([c[1][0] for c in case], CPU)
    qy = fp2.from_int([c[1][1] for c in case], CPU)
    f = pk.pairing_miller(p, qx, qy, torch.zeros(2, dtype=torch.bool),
                          p, qx, qy, torch.ones(2, dtype=torch.bool))
    out = pk.pairing_final_exp(f)[0]
    want = reference("miller_final_exp", repr(case))
    assert torch.equal(out, convert.words_from_ref(want, CPU))
    host = jpairing.pairing(*case[0])
    assert as_ref(tower.f12_to_oracle(out[:1])[0]) == host


def test_product_check_lanes():
    """e(aG1, G2) e(-aG1, G2) == 1 on lanes 0-1, lane 2 corrupted, lane 3
    with a G1 point at infinity on one pair and the other pair's product
    trivial, lane 4 with b's G2 at infinity (then e(aG1, G2) alone)."""
    ks = [5, 31415, 271828, 9, 7]
    a = [host_ec.g1_mul(G1, k) for k in ks]
    b = [host_ec.g1_neg(x) for x in a]
    b[2] = host_ec.g1_mul(G1, 999)
    a[3] = None
    b[3] = host_ec.g1_mul(G1, 9)
    a1, b1 = g1.from_affine_ints(a, CPU), g1.from_affine_ints(b, CPU)
    n = len(ks)
    x = fp2.from_int([G2[0]] * n, CPU)
    y = fp2.from_int([G2[1]] * n, CPU)
    ainf = torch.zeros(n, dtype=torch.bool)
    binf = torch.tensor([False, False, False, True, True])
    ok = pairing_device.pairings_product_is_one(a1, (x, y, ainf), b1,
                                                (x, y, binf))
    assert ok.tolist() == [True, True, False, True, False]


def test_native_and_python_pairing_agree():
    a = host_ec.g1_mul(G1, 31415)
    cases = [(a, G2, host_ec.g1_neg(a), G2),
             (host_ec.g1_mul(G1, 2), host_ec.g2_mul(G2, 3),
              host_ec.g1_neg(host_ec.g1_mul(G1, 6)), G2),
             (a, G2, a, G2), (None, G2, a, None)]
    got = [pairing.pairings_verify(*c) for c in cases]
    assert got == [pairing.pairings_verify_python(*c) for c in cases]
    assert got == [True, True, False, True]
