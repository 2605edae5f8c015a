"""The port's utilities and package surface against kzg_tpu's.

debug (fr_str, debug_frs, debug_g1s print what kzg_tpu prints), mulcount
(the same host counts), profiling and benchloop on the CPU, the names that
every kzg_tpu package re-exports (kzg_tpu.parallel aside: not ported),
and the public helpers: bit reversal, strided roots and the coset scale,
FFTSettings.inv_length, fr.random / from_u64 / scalar_windows,
fp.from_int_batch / to_int_batch, is_power_of_two, secret_from_string,
bench_kzg_settings, take_points. Host values are compared live with
kzg_tpu; nothing of kzg_tpu is compiled."""

import ast
import importlib
import os

import numpy as np
import pytest
import torch
from port_helpers import CPU, random_ints, subgroup_affine

from kzg_tpu_torch.curve import g1, serialization
from kzg_tpu_torch.field import fp, fr
from kzg_tpu_torch.utils import benchloop, debug, mulcount, profiling

R = fr.SPEC.modulus
RNG_INTS = random_ints(np.random.default_rng(170), 6, R)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGES = ("", ".field", ".ntt", ".curve", ".kzg", ".fk20", ".das",
            ".eth", ".utils")


def declared_exports(path: str) -> set:
    """The names an __init__.py binds by its own imports (read from its
    source: which submodules other code loaded does not count)."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", PACKAGES)
def test_package_reexports(sub):
    rel = sub.replace(".", "/")
    ref = declared_exports(os.path.join(ROOT, "kzg_tpu" + rel,
                                        "__init__.py"))
    port = importlib.import_module("kzg_tpu_torch" + sub)
    missing = {n for n in ref if not hasattr(port, n)}
    assert not missing, missing


def test_fr_str_and_debug_frs(capsys):
    from kzg_tpu.field import fr as jfr
    from kzg_tpu.utils import debug as jdebug

    vals = fr.from_int(RNG_INTS, CPU)
    assert debug.fr_str(vals[2]) == jdebug.fr_str(jfr.from_int(RNG_INTS[2]))
    debug.debug_frs("vals", vals)
    got = capsys.readouterr().out
    jdebug.debug_frs("vals", jfr.from_int(RNG_INTS))
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "---vals---" and len(got.splitlines()) == 7


def test_debug_g1s(capsys):
    aff = subgroup_affine(171, 3) + [None]
    debug.debug_g1s("pts", g1.from_affine_ints(aff, CPU))
    want = "---pts---\n" + "".join(
        f"#{i:4d}: {serialization.compress_g1(a).hex()}\n"
        for i, a in enumerate(aff))
    assert capsys.readouterr().out == want


def test_mulcount_equals_reference():
    from kzg_tpu.utils import mulcount as jm

    for n in (2, 16, 4096, 1 << 20):
        assert mulcount.fft_fr(n) == jm.fft_fr(n)
        assert mulcount.das_extension(n) == jm.das_extension(n)
        assert mulcount.batch_inv(n) == jm.batch_inv(n)
        assert mulcount.fft_g1(n, True) == jm.fft_g1(n, True)
        assert mulcount.msm(n) == jm.msm(n)
    assert mulcount.zero_poly(64, 8192) == jm.zero_poly(64, 8192)
    assert mulcount.recover(64, 8192) == jm.recover(64, 8192)
    assert mulcount.fk20_multi_da(4096, 64) == jm.fk20_multi_da(4096, 64)
    assert (mulcount.GLV_BUTTERFLY, mulcount.DYN_LADDER, mulcount.JAC_ADD) \
        == (jm.GLV_BUTTERFLY, jm.DYN_LADDER, jm.JAC_ADD)


def test_profiling_and_benchloop(tmp_path):
    lines = []
    with profiling.timed("block", sink=lines.append):
        x = fr.mul(fr.from_int(RNG_INTS, CPU), fr.from_int(RNG_INTS, CPU))
    assert lines[0].startswith("block: ") and lines[0].endswith(" ms")
    profiling.block({"a": (x, [x])})            # CPU tensors: nothing to wait
    with profiling.trace(str(tmp_path / "tr")):
        fr.add(x, x)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    with profiling.trace(None) as prof:             # no file: the events
        fr.add(x, x)
    assert prof.events() and os.listdir(tmp_path) == ["tr"]
    per_op, out, floored = benchloop.device_loop(
        lambda a, b: fr.add(a, b), (x, x), k=4, windows=2)
    assert per_op > 0 and isinstance(floored, bool)
    assert torch.equal(out, fr.add(x, x))
    per_op, out, _ = benchloop.device_loop(
        lambda a, b: fr.add(a, b), (x, x), k=3, chain=True, windows=1)
    # k + 1 = 4 chained calls from (x, x): x + x + x + x + x
    assert [int(v) for v in fr.to_int(out)] == \
        [5 * a * a % R for a in RNG_INTS]


def test_bit_reversal_helpers():
    from kzg_tpu.ntt import bitrev as jb

    from kzg_tpu_torch.ntt import bitrev

    for n in (1, 2, 8, 1024):
        np.testing.assert_array_equal(bitrev.bit_reversal_indices(n),
                                      jb.bit_reversal_indices(n))
        for v in (0, 1, n // 2, n - 1):
            assert bitrev.reverse_bits_limited(n, v) == \
                jb.reverse_bits_limited(n, v)
    with pytest.raises(ValueError):
        bitrev.bit_reversal_indices(12)
    x = fr.from_int(list(range(16)), CPU)
    got = bitrev.reverse_bit_order(x)
    assert [int(v) for v in fr.to_int(got)] == \
        [int(i) for i in jb.bit_reversal_indices(16)]


def test_strided_roots_coset_scale_inv_length():
    from kzg_tpu.field import fr as jfr
    from kzg_tpu.ntt import FFTSettings as JFFT
    from kzg_tpu.ntt.fft_fr import coset_scale as jcoset

    from kzg_tpu_torch.ntt import FFTSettings, coset_scale
    from kzg_tpu_torch.ntt.fft_fr import take_strided

    fs, jfs = FFTSettings(5, CPU), JFFT(5)
    for inverse in (False, True):
        assert list(fr.to_int(coset_scale(fs, 8, inverse))) == \
            list(jfr.to_int(np.asarray(jcoset(jfs, 8, inverse))))
    assert list(fr.to_int(take_strided(fs.expanded_roots_of_unity, 4, 8))) \
        == [pow(fs.root_of_unity_int, 8 * i, R) for i in range(4)]
    for n in (1, 4, 32):
        assert int(fr.to_int(fs.inv_length(n))) == \
            int(jfr.to_int(np.asarray(jfs.inv_length(n)))) == \
            pow(n, -1, R)
    assert fs.inv_length(4) is fs.inv_length(4)


def test_fr_and_fp_host_helpers():
    from kzg_tpu.field import constants as jc
    from kzg_tpu.field import fr as jfr

    from kzg_tpu_torch.field import constants

    a = fr.random((2, 3), torch.Generator().manual_seed(5), CPU)
    b = fr.random((2, 3), torch.Generator().manual_seed(5), CPU)
    assert a.shape == (2, 3, fr.N_WORDS) and torch.equal(a, b)
    assert fr.random((), torch.Generator().manual_seed(6), CPU).shape == \
        (fr.N_WORDS,)
    assert len({int(v) for v in fr.to_int(a).reshape(-1)}) == 6
    u64 = [0, 1, (1 << 64) - 1, 12345]
    assert list(fr.to_int(fr.from_u64(u64, CPU))) == \
        list(jfr.to_int(jfr.from_u64(u64)))
    wins = fr.scalar_windows(fr.from_int(RNG_INTS, CPU))
    assert wins.shape == (6, 64) and wins.dtype == torch.int32
    for v, row in zip(RNG_INTS, wins.tolist()):
        assert row == [(v >> (4 * i)) & 0xF for i in range(64)]
    ints = random_ints(np.random.default_rng(172), 5, fp.SPEC.modulus)
    ints += [0, fp.SPEC.modulus - 1, fp.SPEC.modulus + 3]
    enc = fp.from_int_batch(ints, CPU)
    assert torch.equal(enc, fp.from_int(ints, CPU))
    assert fp.to_int_batch(enc.reshape(2, 4, fp.N_WORDS)) == \
        [v % fp.SPEC.modulus for v in ints]
    for v in (0, 1, 2, 3, 6, 8, 1 << 20, (1 << 20) + 1):
        assert constants.is_power_of_two(v) == jc.is_power_of_two(v)


def test_setup_helpers_and_take_points():
    from kzg_tpu.kzg import setup as jsetup

    from kzg_tpu_torch.fk20.toeplitz import take_points
    from kzg_tpu_torch.kzg import bench_kzg_settings, secret_from_string
    from kzg_tpu_torch.utils import host_ec

    for s in ("1927409816240961209460912649124", "ff" * 40, "0"):
        assert secret_from_string(s) == jsetup.secret_from_string(s)
    ks = bench_kzg_settings(4, secret=11, device=CPU)
    assert ks.fs.max_scale == 3 and ks.secret_g2_affine is None
    assert g1.to_affine_ints_host(ks.secret_g1) == [
        host_ec.g1_mul(host_ec.g1_generator(), 11 ** i) for i in range(4)]
    picked = take_points(ks.secret_g1, [3, 0, 3])
    assert g1.to_affine_ints_host(picked) == [
        host_ec.g1_mul(host_ec.g1_generator(), k) for k in (1331, 1, 1331)]
