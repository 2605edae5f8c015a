"""The port's zero polynomial and erasure recovery (das/zero_poly.py,
das/recovery.py, and the independent das/legacy.py) against the JAX
package on tests/test_das.py's cases, seeded in port_helpers.py: the
reference's golden vector, tests/oracle.py, and the JAX outputs recorded
by make_reference.py (its fused recovery programs compile for minutes on
the CPU). Values are compared as words and canonical ints."""

import oracle
import pytest
import torch
from port_helpers import (
    CPU,
    LEGACY_CASES,
    RECOVERY_CASES,
    ZERO_POLY_CASES,
    batch_inv_input,
    erasure_only_case,
    recovery_case,
    reference,
    tree_missing,
    zero_poly_missing,
)
from test_das import GOLDEN_ZP_EVAL, GOLDEN_ZP_MISSING, GOLDEN_ZP_POLY

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.das import legacy
from kzg_tpu_torch.das.recovery import (
    recover_poly_from_samples,
    shift_poly,
    unshift_poly,
)
from kzg_tpu_torch.das.zero_poly import zero_poly_via_multiplication
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.domain import FFTSettings

R = fr.SPEC.modulus


def ints(t) -> list:
    return [int(v) for v in fr.to_int(t).reshape(-1)]


def dev(values):
    return fr.from_int(values, CPU)


def ref_words(key: str, *inputs):
    return convert.words_from_ref(reference(key, *inputs), CPU)


def test_zero_poly_golden_vector():
    """reference: zero_poly_test.go:151-197 (tests/test_das.py:244-279)."""
    ze, zc = zero_poly_via_multiplication(FFTSettings(4, CPU),
                                          GOLDEN_ZP_MISSING, 16)
    assert [str(v) for v in fr.to_int(ze)] == GOLDEN_ZP_EVAL
    assert [str(v) for v in fr.to_int(zc)] == GOLDEN_ZP_POLY
    assert torch.equal(torch.stack([ze, zc]),
                       ref_words("zero_poly:golden", GOLDEN_ZP_MISSING))


@pytest.mark.parametrize("scale,ratio", ZERO_POLY_CASES)
def test_zero_poly_matches_reference(scale, ratio):
    missing = zero_poly_missing(scale, ratio)
    fs = FFTSettings(scale + 1, CPU)
    ze, zc = zero_poly_via_multiplication(fs, missing, 1 << scale)
    assert torch.equal(torch.stack([ze, zc]),
                       ref_words(f"zero_poly:{scale}", missing))
    assert (ints(ze), ints(zc)) == oracle.zero_poly(missing, 1 << scale,
                                                    fs.max_width)


@pytest.mark.parametrize("missing", [[], [3]], ids=["empty", "single"])
def test_zero_poly_small_sets(missing):
    ze, zc = zero_poly_via_multiplication(FFTSettings(4, CPU), missing, 16)
    assert (ints(ze), ints(zc)) == oracle.zero_poly(missing, 16, 16)


def test_zero_poly_two_leaf_tree():
    """128 > 64 missing of 256: two leaves and one FFT product level,
    against the JAX package and the legacy direct expansion; the
    evaluations vanish exactly on the missing set."""
    missing = tree_missing()
    fs = FFTSettings(9, CPU)
    ze, zc = zero_poly_via_multiplication(fs, missing, 256)
    assert torch.equal(torch.stack([ze, zc]),
                       ref_words("zero_poly:tree", missing))
    assert torch.equal(zc, legacy.zero_poly_direct(fs, missing, 256))
    miss = set(missing)
    assert [v == 0 for v in ints(ze)] == [i in miss for i in range(256)]


def test_zero_poly_rejects_bad_sizes():
    fs = FFTSettings(4, CPU)
    for missing, length in (([1], 12), ([1], 32), (list(range(16)), 16)):
        with pytest.raises(ValueError):
            zero_poly_via_multiplication(fs, missing, length)


@pytest.mark.parametrize("kind", ["masked", "legacy"])
def test_batch_inv(kind):
    """fr.batch_inv maps the zero lanes 3 and 9 to 0 and inverts the rest;
    the legacy one, given no zero, inverts every lane. Each against the
    JAX package (recorded) and Fermat."""
    vals = batch_inv_input()
    if kind == "masked":
        got = fr.batch_inv(dev(vals))
        assert torch.equal(got, ref_words("batch_inv", jfr.from_int(vals)))
    else:
        vals = [v or 1 for v in vals]
        got = legacy.batch_inv(dev(vals))
        assert torch.equal(got, ref_words("legacy_batch_inv",
                                          jfr.from_int(vals)))
    assert ints(got) == [pow(v, -1, R) if v else 0 for v in vals]


def test_legacy_batch_inv_zero_poisons():
    """Unlike fr.batch_inv, a zero lane zeroes every lane."""
    assert ints(legacy.batch_inv(dev(batch_inv_input()))) == [0] * 13


def test_shift_unshift():
    vals = list(range(1, 9))
    s, u = shift_poly(dev(vals)), unshift_poly(dev(vals))
    assert torch.equal(torch.stack([s, u]),
                       ref_words("shift_poly", jfr.from_int(vals)))
    k_inv = pow(5, -1, R)
    assert ints(s) == [v * pow(5, i, R) % R for i, v in enumerate(vals)]
    assert ints(u) == [v * pow(k_inv, i, R) % R for i, v in enumerate(vals)]
    assert ints(unshift_poly(s)) == vals
    k = 1234567
    assert ints(legacy.p_of_kx(dev(vals), dev(k))) == \
        [v * pow(k, i, R) % R for i, v in enumerate(vals)]


@pytest.mark.parametrize("seed,known_ratio", RECOVERY_CASES)
def test_recover_poly_from_samples(seed, known_ratio):
    """Scale 5 with 50 %, 70 % and 95 % of the samples known (garbage 0
    in the missing lanes)."""
    evals, samples, missing = recovery_case(seed, known_ratio)
    rec = recover_poly_from_samples(FFTSettings(6, CPU), dev(samples),
                                    missing)
    assert torch.equal(rec, ref_words(f"recover:{seed}",
                                      jfr.from_int(samples), missing))
    assert ints(rec) == evals


def test_recover_is_erasure_only():
    """A corrupted known sample comes back verbatim, as in the JAX
    package."""
    samples, missing = erasure_only_case()
    rec = recover_poly_from_samples(FFTSettings(5, CPU), dev(samples),
                                    missing)
    assert torch.equal(rec, ref_words("recover:erasure_only",
                                      jfr.from_int(samples), missing))
    got = ints(rec)
    assert all(got[i] == samples[i] for i in range(16) if i not in missing)


def test_recover_checks_its_arguments():
    fs = FFTSettings(5, CPU)
    samples = dev(list(range(16)))
    with pytest.raises(ValueError, match="n/2"):
        recover_poly_from_samples(fs, samples, list(range(9)))
    with pytest.raises(ValueError, match="n/2"):
        legacy.erasure_code_recover(fs, samples, list(range(9)))
    with pytest.raises(ValueError, match="power of two"):
        recover_poly_from_samples(fs, dev(list(range(12))), [1])
    with pytest.raises(ValueError, match="larger than domain"):
        recover_poly_from_samples(FFTSettings(3, CPU), samples, [1])
    assert recover_poly_from_samples(fs, samples, []) is samples


def test_recover_refuses_shift_in_domain_and_failed_self_check(
        monkeypatch):
    """A shift factor with k^n = 1 would leave zeros in Z's shifted
    evaluations: refused up front. With exact arithmetic the pipeline
    always keeps the known samples (erasure-only above), so the
    self-check (recover_from_samples.go:103-107) is shown on a pipeline
    made to return a wrong lane."""
    from kzg_tpu_torch.das import recovery

    fs, samples = FFTSettings(5, CPU), dev(list(range(16)))
    with monkeypatch.context() as m:
        m.setattr(recovery, "SHIFT_FACTOR", 1)
        with pytest.raises(ValueError, match="shift factor"):
            recovery.recover_poly_from_samples(fs, samples, [1])
    core = recovery._recover_core

    def off_by_one(*args, **kw):
        rec, ez = core(*args, **kw)
        return torch.cat((rec[:1], fr.add(rec[1:2], dev(1)), rec[2:])), ez

    monkeypatch.setattr(recovery, "_recover_core", off_by_one)
    with pytest.raises(ValueError, match="self-check"):
        recovery.recover_poly_from_samples(fs, samples, [0])
    # a missing lane may take any value
    rec = recovery.recover_poly_from_samples(fs, samples, [1])
    assert torch.equal(rec[2:], samples[2:])


@pytest.mark.parametrize("scale,seed", LEGACY_CASES)
def test_legacy_recovery_matches_reference_and_modern(scale, seed):
    """The legacy pipeline (direct zero polynomial, random shift, its
    own batch inversion) with half the lanes missing: equal to the JAX
    package's legacy and modern outputs (recorded), to the port's modern
    pipeline and to the original evaluations."""
    evals, samples, missing = recovery_case(seed, 0.5, scale)
    fs = FFTSettings(scale + 1, CPU)
    got = legacy.erasure_code_recover(fs, dev(samples), missing)
    modern = recover_poly_from_samples(fs, dev(samples), missing)
    want = ref_words(f"legacy:{seed}", jfr.from_int(samples), missing)
    assert torch.equal(torch.stack([got, modern]), want)
    assert ints(got) == evals
