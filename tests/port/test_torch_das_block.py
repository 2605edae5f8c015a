"""The DAS extension's block route (field/kernels.py: das_plan,
fr_das_block and its plain version) against the JAX package's half-FFT
pipeline (_das_core_pallas in interpret mode, recorded: port_helpers.py),
tests/oracle.py and the per-level route it replaces (fr_dif_stage down,
fr_butterfly_stage up, fr_scale), exactly. The tile is capped at 1-3
levels, so that n = 8 and n = 64 run in up to 11 passes and exercise
the kernel's index math; the default plan runs them in one."""

import numpy as np
import oracle
import pytest
import torch
from port_helpers import (
    CPU,
    DAS_CASES,
    das_input,
    random_ints,
    reference,
    slice_evens,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.field import kernels as fk
from kzg_tpu_torch.ntt.das import das_extend_interleaved, das_fft_extension
from kzg_tpu_torch.ntt.domain import FFTSettings

R = fr.SPEC.modulus
CAPS = [1, 2, 3, fk.FFT_TILE_LOG]


def ints(t) -> list:
    return [int(v) for v in fr.to_int(t).reshape(-1)]


def levels(plan) -> list:
    """The (sweep, half-width log) of every level, in the plan's order."""
    out = []
    for lo, kk, sweeps in plan:
        if sweeps & fk.DAS_DOWN:
            out += [("down", lo + st) for st in range(kk - 1, -1, -1)]
        if sweeps & fk.DAS_UP:
            out += [("up", lo + st) for st in range(kk)]
    return out


def stage_route(fs, x):
    """The route fr_das_block replaces: one fr_dif_stage a level down,
    one fr_butterfly_stage a level up, then fr_scale by 1/n."""
    n = x.shape[1]
    K = n.bit_length() - 1
    stride0 = fs.max_width // (2 * n)
    y = x.clone()
    for k in range(K):
        fk.fr_dif_stage(fr.SPEC, y, fs.reverse_roots_of_unity, K - 1 - k,
                        2 * (stride0 << k))
    for k in range(K - 1, -1, -1):
        s = stride0 << k
        fk.fr_butterfly_stage(fr.SPEC, y, fs.expanded_roots_of_unity,
                              K - 1 - k, 2 * s, offset=s)
    return fk.fr_scale(fr.SPEC, y, fr.from_int(pow(n, -1, R), CPU))


@pytest.mark.parametrize("log_n", range(14))
def test_das_plan(log_n):
    """One pass up to 11 levels, three above (the PeerDAS 4096: 6 down,
    6 down and up, 6 up); the levels in the reference's order, each pass
    within the tile limit and the bottom pass the only one with both
    sweeps."""
    plan = fk.das_plan(log_n)
    assert len(plan) == (1 if log_n <= fk.FFT_TILE_LOG else 3)
    assert levels(plan) == ([("down", L) for L in range(log_n - 1, -1, -1)]
                            + [("up", L) for L in range(log_n)])
    assert all(kk <= fk.FFT_TILE_LOG and lo + kk <= log_n
               for lo, kk, _ in plan)
    both = [p for p in plan if p[2] == fk.DAS_DOWN | fk.DAS_UP]
    assert len(both) == 1 and both[0][0] == 0
    if log_n == 12:
        assert plan == ((6, 6, fk.DAS_DOWN), (0, 6, fk.DAS_DOWN | fk.DAS_UP),
                        (6, 6, fk.DAS_UP))


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_das_plan_capped(cap):
    """With the tile capped at `cap` levels: 2 ceil(K / cap) - 1 passes."""
    for log_n in range(14):
        plan = fk.das_plan(log_n, cap)
        assert len(plan) == 2 * max(1, -(-log_n // cap)) - 1
        assert max(kk for _, kk, _ in plan) <= cap
        assert levels(plan) == (
            [("down", L) for L in range(log_n - 1, -1, -1)]
            + [("up", L) for L in range(log_n)])


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("log_n,scale", DAS_CASES)
def test_das_block_matches_reference(log_n, scale, cap):
    """n = 8 and n = 64 (the second on a domain 4x wider than 2n) in 1-11
    passes: the recorded _das_core_pallas output and the oracle."""
    vals = das_input(log_n)
    fs = FFTSettings(scale, CPU)
    x = fr.from_int(vals, CPU).reshape(1, 1 << log_n, 8)
    got = fk.fr_das_block(fr.SPEC, x, fs.reverse_roots_of_unity,
                          fs.expanded_roots_of_unity, fs.max_width,
                          max_tile_log=cap)
    want = reference(f"das:{log_n}", jfr.from_int(vals), scale)
    assert torch.equal(got[0], convert.words_from_ref(want, CPU))
    assert ints(got) == oracle.das_extension(vals)


@pytest.mark.parametrize("cap", CAPS)
def test_das_block_batch_on_wide_domain(cap):
    """Three rows of 16 on the 128-point domain (8x wider than 2n): each
    row equals the oracle, and the batch the per-level stage route."""
    fs = FFTSettings(7, CPU)
    rows = [random_ints(np.random.default_rng(95 + k), 16, R)
            for k in range(3)]
    x = fr.from_int(rows, CPU)
    got = fk.fr_das_block(fr.SPEC, x, fs.reverse_roots_of_unity,
                          fs.expanded_roots_of_unity, fs.max_width,
                          max_tile_log=cap)
    assert got.shape == (3, 16, 8)
    assert [ints(g) for g in got] == [oracle.das_extension(r) for r in rows]
    assert torch.equal(got, stage_route(fs, x))


@pytest.mark.parametrize("cap", CAPS)
def test_das_block_interleaved_matches_reference(cap):
    """The whole slice's 8 evens on the width-32 domain, interleaved in
    the last pass: the recorded das_interleaved case, the evens kept."""
    evens = slice_evens()
    fs = FFTSettings(5, CPU)
    x = fr.from_int(evens, CPU).reshape(1, 8, 8)
    got = fk.fr_das_block(fr.SPEC, x, fs.reverse_roots_of_unity,
                          fs.expanded_roots_of_unity, fs.max_width, True,
                          cap)
    want = reference("das_interleaved", jfr.from_int(evens))
    assert got.shape == (1, 16, 8)
    assert torch.equal(got[0], convert.words_from_ref(want, CPU))
    assert ints(got)[0::2] == evens
    assert torch.equal(got[0], das_extend_interleaved(fs, x[0]))


def test_das_block_rejects_bad_sizes_and_tiles():
    fs = FFTSettings(4, CPU)
    tables = (fs.reverse_roots_of_unity, fs.expanded_roots_of_unity)
    for shape in ((1, 6), (1, 16), (), (1, 0)):
        with pytest.raises(ValueError):
            fk.fr_das_block(fr.SPEC, fr.zeros(shape, CPU), *tables, 16)
    with pytest.raises(ValueError):
        fk.fr_das_block(fr.SPEC, fr.zeros((1, 4), CPU), *tables, 12)
    for cap in (0, fk.FFT_TILE_LOG + 1):
        with pytest.raises(ValueError):
            fk.fr_das_block(fr.SPEC, fr.zeros((1, 4), CPU), *tables, 16,
                            max_tile_log=cap)
        with pytest.raises(ValueError):
            fk.das_plan(3, cap)
    with pytest.raises(ValueError):
        das_fft_extension(fs, fr.zeros((0,), CPU))
