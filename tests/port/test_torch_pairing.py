"""The port's pairing against the JAX package and the exact host tower:
the plain Fp12 tower (curve/tower.py) against kzg_tpu.curve.pairing,
the Frobenius gammas against kzg_tpu's derivation, K-c
(`pairing_final_exp`)'s plain version against the recorded
kzg_tpu pairing_device.final_exponentiation and the host's, K-b
(`pairing_miller`)'s plain version followed by K-c against the recorded
Miller loop + final exponentiation and against pairing(P, Q), the batched
product check with an infinity lane and a corrupted lane, and the native
host pairing against the Python one; K-c's x-chain pieces (the
cyclotomic square against the general square, the powers by |x| and |c|
against the host's pow) and K-b's split (the settings' cached lines of G2
and [s^l]_2, then the evaluation and K-c, against the host pairing; one
set of lines for all lanes against each lane's copy). Exact: canonical
words and ints.

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
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fp
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


def easy_part(x: "jpairing.F12") -> "jpairing.F12":
    """x^((p^6 - 1)(p^2 + 1)): an element of the cyclotomic subgroup."""
    t = x.conj() * x.inv()
    return t.pow(FP_MODULUS ** 2) * t


def test_cyclotomic_sqr_matches_f12_sqr():
    """Granger-Scott squaring equals the general square (and the host's)
    on elements after the final exponentiation's easy part."""
    m = [easy_part(to_jf12(v)) for v in random_f12_ints(150, 2)]
    la = lazy(words(m))
    got = tower.to_words(tower.f12_cyclotomic_sqr(la))
    assert torch.equal(got, tower.to_words(tower.f12_sqr(la)))
    assert [as_ref(v) for v in tower.f12_to_oracle(got)] == [v * v for v in m]


@pytest.mark.parametrize("which", ["x", "c"])
def test_hard_part_powers_match_host_pow(which):
    """K-c's exponentiations by |x| and |c| on cyclotomic squarings equal
    the host tower's pow."""
    from kzg_tpu_torch.field.constants import BLS_X

    e = -BLS_X if which == "x" else pk.HARD_C
    m = easy_part(to_jf12(random_f12_ints(151, 1)[0]))
    got = tower.to_words(pk._cyc_pow(lazy(words([m])), e))
    assert as_ref(tower.f12_to_oracle(got)[0]) == m.pow(e)


def test_fixed_lines_then_final_exp_match_host_pairing():
    """The settings' cached lines of G2 and [s^l]_2 (K-b's lines part),
    K-b's evaluation with every lane on the same lines (one pair flagged
    off in each lane), then K-c, against the host pairing; a second call
    returns the cached tensor."""
    from port_helpers import CRS_SIZE, TEST_SECRET

    from kzg_tpu_torch.kzg.settings import KZGSettings
    from kzg_tpu_torch.kzg.setup import generate_testing_setup
    from kzg_tpu_torch.ntt.domain import FFTSettings

    s1, _, _, s2 = generate_testing_setup(TEST_SECRET, CRS_SIZE, CPU)
    ks = KZGSettings(FFTSettings(5, CPU), s1, s2)
    lines = ks.g2_lines(4, CPU)
    assert lines.shape == (2, pk.N_LINES, 3, 2, 12)
    assert ks.g2_lines(4, CPU) is lines
    pts = [host_ec.g1_mul(G1, 1234567), host_ec.g1_mul(G1, 89)]
    p = g1.from_affine_ints(pts, CPU)
    f = pk.pairing_miller_eval(p, lines[:1], torch.tensor([False, True]),
                               p, lines[1:], torch.tensor([True, False]))
    out = tower.f12_to_oracle(pk.pairing_final_exp(f)[0])
    assert out == [pairing.pairing(pts[0], G2),
                   pairing.pairing(pts[1], ks._s2(4))]


def test_miller_eval_on_shared_and_own_lines_agree():
    """The evaluation on one set of lines for all lanes equals it on each
    lane's own copy, at Jacobian G1 points with Z != 1."""
    q = host_ec.g2_mul(G2, 77)
    lines = pk.pairing_lines(fp2.from_int([q[0]], CPU),
                             fp2.from_int([q[1]], CPU))
    pts = [host_ec.g1_mul(G1, k) for k in (3, 5)]
    z = [7, 11]
    p = FP_MODULUS
    a1 = JacobianPoint(*(fp.from_int(v, CPU) for v in (
        [x * k * k % p for (x, _), k in zip(pts, z)],
        [y * k ** 3 % p for (_, y), k in zip(pts, z)], z)))
    off = torch.zeros(2, dtype=torch.bool)
    shared = pk.pairing_miller_eval(a1, lines, off, a1, lines, ~off)
    each = lines.expand(2, -1, -1, -1, -1)
    own = pk.pairing_miller_eval(a1, each, off, a1, each, ~off)
    assert torch.equal(shared, own)
    got = tower.f12_to_oracle(pk.pairing_final_exp(shared)[0])
    assert got == [pairing.pairing(v, q) for v in pts]
