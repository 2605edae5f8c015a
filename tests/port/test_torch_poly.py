"""The port's polynomial primitives (kzg_tpu_torch/poly.py) against the
JAX package on tests/test_poly.py's cases, seeded in port_helpers.py. The
JAX outputs are recorded (its scans and FFTs compile for seconds to
minutes on the CPU); every case also checks an exact Python-int oracle.
Values are compared as words and canonical ints."""

import oracle
import pytest
import torch
from port_helpers import (
    CPU,
    POLY_X,
    POLY_Z,
    POWERS_N,
    POWERS_X,
    poly_case,
    reference,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert, poly
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.domain import FFTSettings

R = fr.SPEC.modulus
CASE = poly_case()


def ints(t) -> list:
    return [int(v) for v in fr.to_int(t).reshape(-1)]


def dev(values):
    return fr.from_int(values, CPU)


def same(got, key: str, *inputs) -> bool:
    return torch.equal(got, convert.words_from_ref(reference(key, *inputs),
                                                   CPU))


def long_div_oracle(a, b) -> list:
    rem, binv = list(a), pow(b[-1], -1, R)
    q = [0] * (len(a) - len(b) + 1)
    for step in range(len(q)):
        pos = len(a) - 1 - step
        qi = rem[pos] * binv % R
        q[pos - len(b) + 1] = qi
        for j in range(len(b)):
            rem[pos - len(b) + 1 + j] = (rem[pos - len(b) + 1 + j]
                                         - qi * b[j]) % R
    return q


@pytest.mark.parametrize("form", ["horner", "parallel"])
def test_eval_poly(form):
    coeffs, xs = CASE["coeffs"], CASE["xs"]
    want = [oracle.eval_poly(coeffs, x) for x in xs]
    inputs = (jfr.from_int(coeffs), jfr.from_int(xs))
    if form == "horner":
        got = poly.eval_poly_at(dev(coeffs), dev(xs))
        assert same(got, "poly:eval_at", *inputs)
    else:
        got = torch.stack([poly.eval_poly_at_parallel(dev(coeffs), dev(x))
                           for x in xs])
        assert same(got, "poly:eval_at_parallel", *inputs)
    assert ints(got) == want


def test_powers_of_and_sum_fr():
    got = poly.powers_of(dev(POWERS_X), POWERS_N)
    assert same(got, "poly:powers_of", jfr.from_int(POWERS_X))
    assert ints(got) == [pow(POWERS_X, i, R) for i in range(POWERS_N)]
    vals = CASE["sum"]                                  # an odd length
    got = poly.sum_fr(dev(vals), axis=0)
    assert same(got, "poly:sum_fr", jfr.from_int(vals))
    assert ints(got) == [sum(vals) % R]


def test_poly_lin_comb():
    polys, sc = CASE["polys"], CASE["scalars"]
    got = poly.poly_lin_comb(dev(polys), dev(sc))
    assert same(got, "poly:lin_comb", jfr.from_int(polys), jfr.from_int(sc))
    assert ints(got) == [sum(s * p[i] for s, p in zip(sc, polys)) % R
                         for i in range(8)]


def test_poly_factor_div_exact():
    """p = q (x - z): synthetic division gives q back."""
    got = poly.poly_factor_div(dev(CASE["p"]), dev(CASE["z"]))
    assert same(got, "poly:factor_div", jfr.from_int(CASE["p"]),
                jfr.from_int(CASE["z"]))
    assert ints(got) == CASE["q"]


def test_poly_long_div():
    a, b = CASE["dividend"], CASE["divisor"]
    got = poly.poly_long_div(dev(a), dev(b))
    assert same(got, "poly:long_div", jfr.from_int(a), jfr.from_int(b))
    assert ints(got) == long_div_oracle(a, b)
    assert ints(poly.poly_long_div(dev(a), dev(b[:1]))) == \
        [v * pow(b[0], -1, R) % R for v in a]
    assert poly.poly_long_div(dev(b), dev(a)).shape == (0, 8)
    with pytest.raises(ValueError):
        poly.poly_long_div(dev(a), dev(a)[:0])


def test_quotient_on_domain_matches_factor_div():
    c16 = CASE["c16"]
    got = poly.poly_quotient_on_domain(FFTSettings(5, CPU), dev(c16),
                                       dev(POLY_Z))
    assert same(got, "poly:quotient_on_domain", jfr.from_int(c16),
                jfr.from_int(POLY_Z))
    shifted = [(c16[0] - oracle.eval_poly(c16, POLY_Z)) % R] + c16[1:]
    assert ints(got) == ints(poly.poly_factor_div(dev(shifted), dev(POLY_Z)))


@pytest.mark.parametrize("where", ["off", "on"])
def test_eval_poly_in_evaluation_form(where):
    """Barycentric evaluation off the domain, and on domain point 5,
    whose stored evaluation comes back (its denominator is replaced by 1
    before the batch inversion)."""
    fs = FFTSettings(4, CPU)
    c16 = CASE["c16"]
    evals = oracle.fft(c16)
    domain = [pow(fs.root_of_unity_int, i, R) for i in range(16)]
    x = POLY_X if where == "off" else domain[5]
    got = poly.eval_poly_in_evaluation_form(dev(evals), dev(domain), dev(x),
                                            dev(pow(16, -1, R)))
    assert same(got, f"poly:eval_form:{where}", jfr.from_int(c16),
                jfr.from_int(x))
    assert ints(got) == [oracle.eval_poly(c16, x)]
