"""The port's DAS extension (fr_dif_stage down, fr_butterfly_stage up,
fr_scale exit; their plain versions on the CPU) against the reference's
golden vector, tests/oracle.py and the JAX package's half-FFT pipeline
(_das_core_pallas in interpret mode, recorded: port_helpers.py); and the
whole producer slice at n = 8, n2 = 16: extend -> inverse FFT -> commit ->
FK20 proofs, against the JAX package and the oracle. Field values are
compared as canonical ints or words, points in affine form."""

import numpy as np
import oracle
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    DAS_CASES,
    FK20_COEFFS,
    FK20_N,
    FK20_N2,
    TEST_SECRET,
    coset_proofs_oracle,
    das_input,
    eval_poly,
    random_ints,
    ref_to_port,
    reference,
    slice_evens,
)
from test_ntt import GOLDEN_DAS_0_7

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.field import kernels as fk
from kzg_tpu_torch.ntt.das import das_extend_interleaved, das_fft_extension
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.ntt.fft_fr import fft
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus


def ints(t) -> list:
    return [int(v) for v in fr.to_int(t).reshape(-1)]


def test_das_extension_golden():
    """reference: das_extension_test.go:25-39 (tests/test_ntt.py:116)."""
    odds = das_fft_extension(FFTSettings(4, CPU), fr.from_int(range(8), CPU))
    assert ints(odds) == [int(s) for s in GOLDEN_DAS_0_7]
    assert oracle.das_extension(list(range(8))) == ints(odds)


@pytest.mark.parametrize("log_n,scale", DAS_CASES)
def test_das_fft_extension_matches_reference(log_n, scale):
    """n = 8 and n = 64 (past the reference's reduce_hi boundary), the
    second on a domain 4x wider than 2n (the twiddle stride)."""
    vals = das_input(log_n)
    got = das_fft_extension(FFTSettings(scale, CPU), fr.from_int(vals, CPU))
    want = reference(f"das:{log_n}", jfr.from_int(vals), scale)
    assert torch.equal(got, convert.words_from_ref(want, CPU))
    assert ints(got) == oracle.das_extension(vals)


@pytest.mark.parametrize("log_n", [0, 1, 2, 5])
def test_das_extension_batch_matches_oracle(log_n):
    """Every size up to 32 with a leading batch axis of 2 rows, on the
    width-64 domain."""
    rows = [random_ints(np.random.default_rng(80 + log_n + k), 1 << log_n, R)
            for k in range(2)]
    got = das_fft_extension(FFTSettings(6, CPU), fr.from_int(rows, CPU))
    assert got.shape == (2, 1 << log_n, 8)
    assert [ints(g) for g in got] == [oracle.das_extension(r) for r in rows]


def test_das_extension_rejects_bad_sizes():
    with pytest.raises(ValueError):
        das_fft_extension(FFTSettings(3, CPU), fr.zeros((8,), CPU))
    with pytest.raises(ValueError):
        das_extend_interleaved(FFTSettings(4, CPU), fr.zeros((6,), CPU))


def test_fr_dif_stage_matches_pallas_level():
    """One down-sweep level of _das_core_pallas (_butterfly_lazy_dif_fn,
    first level of the n = 64 case): its lazy R-form outputs, reduced mod
    r, equal the canonical DIF stage's."""
    log_n, scale = DAS_CASES[1]
    vals = das_input(log_n)
    fs = FFTSettings(scale, CPU)
    stride = fs.max_width >> log_n                      # 2 * stride_0
    x = fr.from_int(vals, CPU).reshape(1, 1 << log_n, 8)
    got = fk.fr_dif_stage(fr.SPEC, x.clone(), fs.reverse_roots_of_unity,
                          log_n - 1, stride)
    lazy = reference("dif_level", jfr.from_int(vals), scale)   # (2, 17, 32)
    want = [[fr.SPEC.from_mont_int(
        sum(int(v) << (16 * i) for i, v in enumerate(lane)) % R)
        for lane in part.T] for part in lazy]
    assert ints(got) == want[0] + want[1]
    w_inv = pow(pow(7, (R - 1) >> scale, R), -stride, R)
    half = 1 << (log_n - 1)
    assert ints(got)[half:] == [(a - b) * pow(w_inv, j, R) % R for j, (a, b)
                                in enumerate(zip(vals[:half], vals[half:]))]


def test_fr_butterfly_stage_offset():
    """The up-sweep's odd twiddles: roots[offset + j stride], multiplied
    even at width 2 (log_half 0), where an FFT stage skips the multiply."""
    fs = FFTSettings(4, CPU)
    roots = fs.roots_of_unity_int()
    xv = random_ints(np.random.default_rng(90), 16, R)
    x = fr.from_int(xv, CPU).reshape(1, 16, 8)
    for log_half, stride, offset in ((0, 2, 1), (2, 2, 1), (1, 4, 2)):
        got = ints(fk.fr_butterfly_stage(fr.SPEC, x.clone(),
                                         fs.expanded_roots_of_unity,
                                         log_half, stride, offset))
        half = 1 << log_half
        for g in range(0, 16, 2 * half):
            for j in range(half):
                a = xv[g + j]
                b = xv[g + j + half] * roots[offset + j * stride] % R
                assert got[g + j] == (a + b) % R
                assert got[g + j + half] == (a - b) % R


def test_producer_slice_matches_reference():
    """A blob builder's path on the kzg_env shape: 8 evens -> 16-value
    extension -> inverse FFT (top half zero) -> commitment -> FK20 proofs
    (l = 4), each step against the JAX package and the oracle."""
    evens = slice_evens()
    fs = FFTSettings(5, CPU)
    ext = das_extend_interleaved(fs, fr.from_int(evens, CPU))
    want = reference("das_interleaved", jfr.from_int(evens))
    assert torch.equal(ext, convert.words_from_ref(want, CPU))
    assert ints(ext)[0::2] == evens

    coeffs = fft(fs, ext, inverse=True)
    assert ints(coeffs) == FK20_COEFFS + [0] * FK20_N

    crs = reference("crs", TEST_SECRET, CRS_SIZE)
    l = 4
    fkm = convert.fk20_settings_from_reference(
        fs, crs, FK20_N2, l, reference(f"fk20:{l}:tables", TEST_SECRET,
                                       CRS_SIZE, l))
    commit = fkm.ks.commit_to_poly(coeffs[:FK20_N])
    got = g1.to_affine_ints(JacobianPoint(*(c[None] for c in commit)))
    want = ref_to_port(reference("commit_to_poly", TEST_SECRET, CRS_SIZE,
                                 jfr.from_int(FK20_COEFFS)))
    assert got == g1.to_affine_ints(JacobianPoint(*(c[None] for c in want)))
    s = TEST_SECRET % R
    assert got == [host_ec.g1_mul(host_ec.g1_generator(),
                                  eval_poly(FK20_COEFFS, s, R))]

    proofs = g1.to_affine_ints(fkm.fk20_multi_da_optimized(coeffs))
    ext_coeffs = FK20_COEFFS + [0] * FK20_N
    assert proofs == g1.to_affine_ints(ref_to_port(reference(
        f"fk20:{l}:da_optimized", jfr.from_int(ext_coeffs), l)))
    assert proofs == coset_proofs_oracle(FK20_COEFFS, FK20_N2, l,
                                         TEST_SECRET, rbo=False)
