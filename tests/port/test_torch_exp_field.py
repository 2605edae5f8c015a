"""The field-chain experiments (kzg_tpu_torch.experiments) on the CPU: the
plain versions of exp_mont_chain (variants A, B, C), exp_tc_mont_mul (the
hybrid product and its two passes) and exp_op_chain (six ops) against the
JAX package's recorded outputs on the scripts' inputs
(tests/port/make_reference.py, group exp_field: scripts/exp_montmul.py's
variant A body, scripts/exp_mxu_mul.py's interpreted Pallas kernel,
mxu_const_mul and hybrid_mont_mul, scripts/exp_addsub.py's tile ops) and
against Python ints, exactly. Nothing here compiles JAX."""

import json

import numpy as np
import pytest
import torch

import port_helpers as ph
from kzg_tpu_torch import convert
from kzg_tpu_torch.experiments import exp_addsub, exp_montmul, exp_mxu_mul
from kzg_tpu_torch.experiments import kernels as ek

CPU = ph.CPU
# the recorder's chain depth (make_reference.EXP_DEPTH)
DEPTH = 8


def lane_limbs(words: torch.Tensor) -> np.ndarray:
    """(lanes, N) words -> the scripts' (2N, lanes) uint32 16-bit limbs."""
    return np.ascontiguousarray(convert.words_to_ref(words).T)


def from_lane_limbs(limbs16) -> torch.Tensor:
    return convert.words_from_ref(np.asarray(limbs16).T, device=CPU)


def ints(t: torch.Tensor) -> list:
    return exp_montmul.word_ints(t, range(t.shape[0]))


@pytest.mark.parametrize("variant", ek.VARIANTS)
@pytest.mark.parametrize("field", ["Fr", "Fp"])
def test_mont_chain_vs_recorded(field, variant):
    """Every variant's chain equals mont_mul_tile in lax.fori_loop (the
    TPU's variant A body) at depth 8 on the script's 64 lanes."""
    spec = ek.SPECS[field]
    a, b = exp_montmul.inputs(spec, 64, CPU)
    want = ph.reference(f"exp_montmul:{field}", lane_limbs(a), lane_limbs(b),
                        DEPTH)
    got = ek.exp_mont_chain(spec, a, b, variant, DEPTH)
    assert torch.equal(got, from_lane_limbs(want))


@pytest.mark.parametrize("variant", ek.VARIANTS)
@pytest.mark.parametrize("field", ["Fr", "Fp"])
def test_mont_chain_full_depth_ints(field, variant):
    """The script's own check (scripts/exp_montmul.py:236-248): 256
    products on 2 lanes against Python ints."""
    spec = ek.SPECS[field]
    a, b = exp_montmul.inputs(spec, 2, CPU)
    out = ek.exp_mont_chain_plain(spec, a, b, variant, exp_montmul.DEPTH)
    assert exp_montmul.check_lanes(spec, a, b, out, exp_montmul.DEPTH)


def w0_inputs():
    xs, ys, _ = exp_mxu_mul.inputs((), CPU)
    return xs, ys, ek.FP.words(xs, CPU), ek.FP.words(ys, CPU)


def test_hybrid_vs_recorded():
    """The hybrid product equals the interpreted pallas_hybrid_mul_fn and
    the XLA-level hybrid_mont_mul at W = 256, and Python ints."""
    xs, ys, a, b = w0_inputs()
    a16, b16 = convert.words_to_ref(a), convert.words_to_ref(b)
    got = ek.exp_tc_mont_mul(a, b)
    pk = ph.reference("exp_mxu_mul:pallas_hybrid", a16, b16)
    xla = ph.reference("exp_mxu_mul:hybrid_mont_mul", a16, b16)
    assert torch.equal(got, from_lane_limbs(pk))
    assert torch.equal(got, convert.words_from_ref(xla, device=CPU))
    rinv = ek.FP.r_inv
    assert ints(got) == [x * y * rinv % ek.FP.modulus for x, y in zip(xs, ys)]


@pytest.mark.parametrize("mode", ["tc_pass", "cc_pass"])
def test_pass_vs_recorded(mode):
    """Both by-constant passes equal the script's mxu_const_mul (x n' mod
    R) and Python ints."""
    xs, _, a, _ = w0_inputs()
    want = ph.reference("exp_mxu_mul:mxu_const_mul", convert.words_to_ref(a))
    got = ek.exp_tc_mont_mul(a, mode=mode)
    assert torch.equal(got, convert.words_from_ref(want, device=CPU))
    assert ints(got) == [x * ek.FP.nprime % ek.FP.r for x in xs]


@pytest.mark.parametrize("op", ek.OPS)
def test_op_chain_vs_recorded(op):
    """Each small op's chain equals the TPU tile op's at depth 8 on the
    script's 64 lanes, and Python ints at depth 8 and 256."""
    a = exp_addsub.inputs(64, CPU)
    want = ph.reference(f"exp_addsub:{op}", lane_limbs(a), DEPTH)
    got = ek.exp_op_chain(a, op, DEPTH)
    assert torch.equal(got, from_lane_limbs(want))
    assert ints(got) == [exp_addsub.expected(op, x, DEPTH) for x in ints(a)]
    deep = ek.exp_op_chain_plain(a[:2], op, exp_addsub.DEPTH)
    assert ints(deep) == [exp_addsub.expected(op, x, exp_addsub.DEPTH)
                          for x in ints(a[:2])]


def test_mont_mul_operand_below_r():
    """mont_mul(x, c) with c = n' (below R, not below p, so not a field
    element) is REDC(x c) = x c R^-1 mod p for canonical x, the ends of
    the range included."""
    p = ek.FP.modulus
    xs = [0, 1, p - 1, p - 2, (1 << 380) % p] + ph.random_ints(
        np.random.default_rng(5), 8, p)
    got = ek.exp_op_chain(ek.FP.words(xs, CPU), "mont_mul(x,c)", 1)
    assert ek.FP.nprime > p
    assert ints(got) == [x * ek.FP.nprime * ek.FP.r_inv % p for x in xs]


def byte_columns_int(x: int, c: int, in_digits: int, out_digits: int):
    xd = [(x >> (8 * i)) & 0xFF for i in range(in_digits)]
    cd = [(c >> (8 * j)) & 0xFF for j in range(out_digits)]
    return [sum(xd[i] * cd[k - i] for i in range(min(in_digits, k + 1)))
            for k in range(out_digits)]


@pytest.mark.parametrize("which", ["nprime", "modulus"])
@pytest.mark.parametrize("field", ["Fr", "Fp"])
def test_toeplitz_matrices(field, which):
    """(byte digits of x) @ T equals the byte-column sums of x*c, which
    recombine to x n' mod R (the q pass) or x m (the q m pass)."""
    spec = ek.SPECS[field]
    tq, tqm = ek.toeplitz_pair(spec)
    t, c = (tq, spec.nprime) if which == "nprime" else (tqm, spec.modulus)
    d = 4 * spec.n_words
    assert t.shape == (d, d if which == "nprime" else 2 * d)
    assert t.dtype == np.uint8
    rng = np.random.default_rng(11)
    for x in ph.random_ints(rng, 4, spec.r) + [spec.r - 1]:
        digits = np.array([(x >> (8 * i)) & 0xFF for i in range(d)],
                          dtype=np.int64)
        cols = digits @ t.astype(np.int64)
        assert cols.tolist() == byte_columns_int(x, c, d, t.shape[1])
        assert max(cols) < 1 << 22          # exact in s32, as the kernel
        value = sum(int(v) << (8 * k) for k, v in enumerate(cols))
        mod = 1 << (8 * t.shape[1])
        assert value % mod == x * c % mod


@pytest.mark.parametrize("field", ["Fr", "Fp"])
def test_pass_macs(field):
    """The byte products the bound counts for the two passes are the band
    of each Toeplitz matrix (0 <= k - i < 4N): 528 and 1024 a lane for Fr,
    1176 and 2304 for Fp."""
    spec = ek.SPECS[field]
    d = 4 * spec.n_words
    band = [int(np.sum((k - i >= 0) & (k - i < d)))
            for i, k in (np.indices(t.shape) for t in ek.toeplitz_pair(spec))]
    assert ek.pass_macs(spec) == tuple(band)
    assert band == {"Fr": [528, 1024], "Fp": [1176, 2304]}[field]


def test_plain_versions_reject_unknown_cases():
    a, b = exp_montmul.inputs(ek.SPECS["Fr"], 2, CPU)
    with pytest.raises(ValueError):
        ek.exp_mont_chain(ek.SPECS["Fr"], a, b, "D", 1)
    with pytest.raises(ValueError):
        ek.exp_tc_mont_mul(a, mode="mxu")
    with pytest.raises(ValueError):
        ek.exp_op_chain(a, "lazy_add", 1)


@pytest.mark.parametrize("module,argv", [
    (exp_montmul, ["--device", "cpu", "--depth", "2", "--lanes", "4"]),
    (exp_mxu_mul, ["--device", "cpu", "--widths", "32"]),
    (exp_addsub, ["--device", "cpu", "--depth", "2", "--lanes", "4"]),
], ids=["exp_montmul", "exp_mxu_mul", "exp_addsub"])
def test_entry_points_on_cpu(module, argv, capsys):
    """Each entry point runs its plain versions with --device cpu, prints
    one JSON line a measurement, every one correct, and exits 0."""
    assert module.main(argv) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines and all(r["correct"] is True for r in lines)
    assert all(r["device"] == "cpu" for r in lines)
    n = {exp_montmul: 6, exp_mxu_mul: 1 + 5, exp_addsub: 6}[module]
    assert len(lines) == n
