"""The product-body experiments (kzg_tpu_torch.experiments: exp_ab_mul,
exp_carry, exp_truth, exp_addcost) on the CPU: the plain versions of
exp_tuple_chain and exp_ext_chain against the JAX package's recorded
outputs on the scripts' inputs (tests/port/make_reference.py, group
exp_chain) wherever both compute the same integer, and against Python-int
models of the kernels' arithmetic, exactly. Nothing here compiles JAX.

The recorded outputs are first held to the models. Where the two compute
different integers, the port is held to its model alone:
- lazy13 is REDC over 2^416; the TPU's one headroom limb (25 rows) makes
  its lazy product REDC over 2^400, another integer.
- lazy16 against the script's 32 rows, and its 25 rows: scripts/exp_ab_mul
  pads n' = -p^-1 mod 2^384 with zero rows (its docstring calls a lazy
  case "numerically wrong"), which is not -p^-1 mod 2^512 (2^400), so q p
  does not cancel T's low half and the dropped half is not zero: the
  recorded words equal a model of that arithmetic and not REDC.
- raw12 drops the carry out of each 32-bit word; the TPU's drops it out
  of each 16-bit limb. It is not recorded.
subs12, the script's case, leaves c = K m from its third extra on, so all
its outputs are 0; subs1, a case of the port's only, takes one lazy sub
and is recorded too, so that the sub's words reach what is compared.
Every other case is exact field arithmetic after from_ext, or the same
REDC integer, so it equals its record word for word.
"""

import json

import numpy as np
import pytest
import torch

import port_helpers as ph
from kzg_tpu_torch import convert
from kzg_tpu_torch.experiments import (exp_ab_mul, exp_addcost, exp_carry,
                                       exp_truth)
from kzg_tpu_torch.experiments import kernels as ek
from kzg_tpu_torch.experiments.exp_montmul import word_ints
from kzg_tpu_torch.field import limbs

CPU = ph.CPU
# the recorder's depth and lanes (make_reference.EXP_DEPTH)
DEPTH = 8
LANES = 64
P = ek.FP.modulus
# the records of exp_ab_mul's four products, and of exp_addcost's variants
AB_RECORD = {"mont12": "mont24", "lazy12": "lazy24", "lazy16": "lazy32"}
EXT_ALL = ek.EXT_CASES + ek.EXT_CHECK_CASES
EXT_RECORDED = [c for c in EXT_ALL if c[0] != "raw"]


def lane_limbs(words: torch.Tensor) -> np.ndarray:
    """(lanes, 12) words -> the scripts' (24, lanes) uint32 16-bit limbs."""
    return np.ascontiguousarray(convert.words_to_ref(words).T)


def limb_ints(rows) -> list:
    """(L, lanes) 16-bit limbs -> one Python int a lane."""
    rows = np.asarray(rows, dtype=object)
    return [sum(int(v) << (16 * k) for k, v in enumerate(rows[:, i]))
            for i in range(rows.shape[1])]


def ints(t: torch.Tensor) -> list:
    return word_ints(t, range(t.shape[0]))


@pytest.fixture(scope="module")
def x64():
    return exp_ab_mul.inputs(LANES, CPU)


@pytest.fixture(scope="module")
def pts64():
    return exp_addcost.inputs(LANES, CPU)


def script_lazy_int(t: int, rows: int, nprime: int) -> int:
    """lazy_mul_tile at `rows` 16-bit rows with the constant `nprime`:
    q = t nprime mod 2^(16 rows), (t + q p) / 2^(16 rows) rounded down,
    mod 2^(16 rows). REDC where nprime = -p^-1 mod 2^(16 rows)."""
    bits = 16 * rows
    mask = (1 << bits) - 1
    q = (t * nprime) & mask
    return ((t + q * P) >> bits) & mask


def script_body_int(rows: int, nprime: int, x: int) -> int:
    def M(a, b):
        return script_lazy_int(a * b, rows, nprime)

    y = z = x
    for _ in range(DEPTH):
        a, b, c = M(x, y), M(y, z), M(z, x)
        d, e = M(a, b), M(b, c)
        x, y, z = M(d, e), M(e, a), c
    return x


@pytest.mark.parametrize("record,product", [
    ("mont24", "mont12"), ("lazy24", "lazy12"), ("lazy25", None),
    ("lazy32", None)])
def test_recorded_ab_mul_against_models(x64, record, product):
    """The TPU's 24-row products are the port's mont12 and lazy12 models
    (REDC over 2^384). Its 25- and 32-row lazy products take the script's
    n' = -p^-1 mod 2^384 padded with zero rows: the records equal that
    arithmetic's model and differ from REDC over 2^400 and 2^512 (the
    latter the port's lazy16) on every lane."""
    rec = ph.reference(f"exp_ab_mul:{record}", lane_limbs(x64), DEPTH)
    got, xs = limb_ints(rec), ints(x64)
    if product is not None:
        assert got == [exp_ab_mul.body_int(product, v, DEPTH) for v in xs]
        return
    rows = int(record[4:])
    assert got == [script_body_int(rows, ek.FP.nprime, v) for v in xs]
    r = 1 << (16 * rows)
    redc = [script_body_int(rows, (-pow(P, -1, r)) % r, v) for v in xs]
    assert all(g != w for g, w in zip(got, redc))
    if rows == 32:
        assert redc == [exp_ab_mul.body_int("lazy16", v, DEPTH) for v in xs]


@pytest.mark.parametrize("product", ek.PRODUCTS)
def test_tuple3_vs_recorded(x64, product):
    """Each product's 7-product body at depth 8 on the script's 64 lanes:
    the plain version equals the Python-int model, and the recorded TPU
    body where it computes the same integer (mont12: mont_mul_tile at 24
    rows in exp_ab_mul's and exp_carry's shapes; lazy12: lazy_mul_tile at
    24 rows)."""
    got = ek.exp_tuple_chain(x64, "tuple3", product, DEPTH)
    assert ints(got) == [exp_ab_mul.body_int(product, v, DEPTH)
                         for v in ints(x64)]
    if product in ("mont12", "lazy12"):
        rec = ph.reference(f"exp_ab_mul:{AB_RECORD[product]}",
                           lane_limbs(x64), DEPTH)
        assert np.array_equal(lane_limbs(got), rec)
    if product == "mont12":
        rec = ph.reference("exp_carry:tuple3", lane_limbs(x64), DEPTH)
        assert np.array_equal(lane_limbs(got), rec)


@pytest.mark.parametrize("body", ["single", "serial"])
def test_carry_vs_recorded(x64, body):
    """exp_carry's other two carries: the (72, W) array's body (single)
    and seven squarings an iteration (serial), against their records and
    the model."""
    got = ek.exp_tuple_chain(x64, body, "mont12", DEPTH)
    rec = ph.reference(f"exp_carry:{body}", lane_limbs(x64), DEPTH)
    assert np.array_equal(lane_limbs(got), rec)
    assert ints(got) == [exp_ab_mul.body_int("mont12", v, DEPTH, body)
                         for v in ints(x64)]


@pytest.mark.parametrize("product", ["lazy12", "lazy13", "lazy16"])
def test_serial_latency_probes(x64, product):
    """The serial body on the lazy products (the latency probes of
    chip_smoke.py) against the model."""
    got = ek.exp_tuple_chain(x64[:8], "serial", product, DEPTH)
    assert ints(got) == [exp_ab_mul.body_int(product, v, DEPTH, "serial")
                         for v in ints(x64[:8])]


@pytest.mark.parametrize("kind,nextra", EXT_ALL,
                         ids=[f"{k}{n}" for k, n in EXT_ALL])
def test_ext_chain_vs_recorded(pts64, kind, nextra):
    """X6's and X11's body at depth 8 on 64 of the scripts' points: the
    plain version equals the model, and for every case but raw12 the
    TPU's canonical words after from_ext (R_ext = 2^400 there, 2^416
    here: the same field elements). subs12's words are all 0, subs1's
    are not."""
    got = ek.exp_ext_chain(*pts64, kind, nextra, DEPTH)
    zero = all(not torch.any(g) for g in got)
    assert zero == ((kind, nextra) == ("subs", 12))
    ins = list(zip(*(ints(c) for c in pts64)))
    assert list(zip(*(ints(c) for c in got))) == [
        exp_addcost.body_int(kind, nextra, pt, DEPTH) for pt in ins]
    if kind != "raw":
        rec = ph.reference(f"exp_addcost:{kind}{nextra}",
                           *(lane_limbs(c) for c in pts64), DEPTH)
        for g, r in zip(got, rec):
            assert np.array_equal(lane_limbs(g), r)


SCRIPT_TUPLE_CASES = [("tuple3", p) for p in ek.PRODUCTS] + [
    ("single", "mont12"), ("serial", "mont12")]


@pytest.mark.parametrize("body,product", SCRIPT_TUPLE_CASES,
                         ids=[f"{b}-{p}" for b, p in SCRIPT_TUPLE_CASES])
def test_tuple_chain_full_depth(x64, body, product):
    """The scripts' cases at their full depth, 64 iterations, on 2
    lanes."""
    x = x64[:2]
    got = ek.exp_tuple_chain_plain(x, body, product, exp_ab_mul.DEPTH)
    assert exp_ab_mul.check_lanes(x, got, product, exp_ab_mul.DEPTH, body)


@pytest.mark.parametrize("kind,nextra,depth",
                         [(k, n, exp_addcost.DEPTH) for k, n in EXT_ALL]
                         + [("adds", 0, exp_truth.DEPTHS[1])],
                         ids=[f"{k}{n}" for k, n in EXT_ALL]
                         + ["exp_truth-512"])
def test_ext_chain_full_depth(pts64, kind, nextra, depth):
    """exp_addcost's 64 iterations, and exp_truth's 512, on 2 lanes."""
    pts = tuple(c[:2] for c in pts64)
    got = ek.exp_ext_chain_plain(*pts, kind, nextra, depth)
    assert exp_addcost.check_lanes(pts, got, kind, nextra, depth)


def words_of(vals, n_words):
    return torch.tensor([limbs.int_to_limbs(v, 2 * n_words) for v in vals],
                        dtype=torch.int64)


def from_limbs(t) -> list:
    return [sum(int(v) << (16 * k) for k, v in enumerate(r))
            for r in t.tolist()]


@pytest.mark.parametrize("n_words,bound", [(12, 2 * P), (13, 1 << 416),
                                           (16, 2 * P)])
def test_lazy_product_edges(n_words, bound):
    """The plain lazy product is (T + q p) / R mod R at the ends of each
    case's operand range (below 2p for lazy12 and lazy16; any 13-word
    value, as a raw sum may be, for lazy13), and the conditional
    subtraction takes a value below 2p to [0, p)."""
    rng = np.random.default_rng(9)
    vals = [0, 1, P - 1, P, 2 * P - 1, bound - 1] + ph.random_ints(
        rng, 10, bound)
    others = [bound - 1, P - 1, 2, P + 1, 1, 0] + ph.random_ints(
        rng, 10, min(bound, 2 * P))
    got = from_limbs(ek.lazy_mul_limbs(words_of(vals, n_words),
                                       words_of(others, n_words), n_words))
    assert got == [ek.redc_int(a * b, n_words) for a, b in zip(vals, others)]
    small = [v for v in vals if v < 2 * P]
    assert from_limbs(ek.cond_sub_limbs(words_of(small, n_words),
                                        n_words)) == [v % P for v in small]


@pytest.mark.parametrize("kind", ["adds", "subs", "raw"])
def test_ext_ops_edges(kind):
    """The extra ops mod 2^416 against the model, with a wrap below zero
    (subs: b > a + K p) and carries out of every word (raw)."""
    top = (1 << 416) - 1
    a = [0, 1, P, top, 0xFFFFFFFF, ek.EXT_KM]
    b = [top, ek.EXT_KM + 5, 3 * P, top, 1, ek.EXT_KM]
    got = from_limbs(ek._ext_op_plain(kind, words_of(a, 13),
                                      words_of(b, 13)))
    assert got == [exp_addcost.extra_int(kind, u, v) for u, v in zip(a, b)]


def test_ext_domain_round_trip(pts64):
    """to_ext takes aR to aR_ext (R_ext = 2^416) and from_ext back, both
    on lazy13: C_IN = 2^448 and C_OUT = 2^384 mod p."""
    r_ext = 1 << 416
    for v in ints(pts64[0][:4]):
        e = ek.redc_int(v * ek.EXT_C_IN, 13)
        assert e % P == v * pow(2, 32, P) % P
        assert e < 2 * P
        back = ek.redc_int(e * ek.EXT_C_OUT, 13)
        assert back % P == v and back < 2 * P
    assert ek.EXT_C_IN == pow(2, 2 * 416 - 384, P) and r_ext > 64 * P


def audit_ext_chain(kind: str, nextra: int, point, depth: int) -> dict:
    """The model's body, watched: the largest value a product reads, the
    largest product of its operands, and the extras (by j) whose exact
    sum left [0, 2^416)."""
    r_ext = 1 << 416
    seen = {"value": 0, "product": 0, "wrapped": set()}

    def M(a, b):
        seen["value"] = max(seen["value"], a, b)
        seen["product"] = max(seen["product"], a * b)
        return ek.redc_int(a * b, 13)

    x, y, z = (M(v, ek.EXT_C_IN) for v in point)
    for _ in range(depth):
        a, b, c = M(x, y), M(y, z), M(z, x)
        for j in range(nextra):
            s = (a, b, c)[j % 3]
            exact = s + c if kind in ("adds", "fold") else s + ek.EXT_KM - c
            if not 0 <= exact < r_ext:
                seen["wrapped"].add(j)
            c = exp_addcost.extra_int(kind, s, c)
        d, e = M(a, b), M(b, c)
        x, y = M(d, e), M(e, a)
        z = M(x, y)
    return seen


@pytest.mark.parametrize("kind,nextra", EXT_RECORDED,
                         ids=[f"{k}{n}" for k, n in EXT_RECORDED])
def test_ext_chain_bound_audit(pts64, kind, nextra):
    """The kernel header's audit on 8 lanes at depth 8: every product
    reads values below 100p (adds12's c doubles on every third extra),
    so its operands multiply to below p 2^416, REDC's input bound; no
    lazy add wraps; subs12 may wrap below zero only at its second extra
    (the K m of the first two cancel), and its third sets c to exactly
    K m, before any product reads c; subs1 never wraps."""
    for pt in zip(*(ints(c[:8]) for c in pts64)):
        seen = audit_ext_chain(kind, nextra, pt, DEPTH)
        assert seen["value"] < 100 * P
        assert seen["product"] < P << 416
        assert seen["wrapped"] <= ({1} if (kind, nextra) == ("subs", 12)
                                   else set())
    x, y, z = (ek.redc_int(v * ek.EXT_C_IN, 13)
               for v in next(zip(*(ints(c[:1]) for c in pts64))))
    a, b, c = (ek.redc_int(u * v, 13) for u, v in ((x, y), (y, z), (z, x)))
    for j in range(3):
        c = exp_addcost.extra_int("subs", (a, b, c)[j % 3], c)
    assert c == ek.EXT_KM


def test_lazy12_chain_stays_below_2p(x64):
    """lazy12's audit: 4p < 2^384, so a product of operands below 2p is
    below p 2^384 and its output below 2p; the chain's values stay there
    on the script's inputs."""
    assert 4 * P < 1 << 384 and 3 * P < 1 << 384
    for v in ints(x64[:8]):
        x = y = z = v
        for _ in range(DEPTH):
            def M(a, b):
                assert a < 2 * P and b < 2 * P
                return ek.redc_int(a * b, 12)

            a, b, c = M(x, y), M(y, z), M(z, x)
            d, e = M(a, b), M(b, c)
            x, y, z = M(d, e), M(e, a), c


def test_plain_versions_reject_unknown_cases(x64):
    with pytest.raises(ValueError):
        ek.exp_tuple_chain(x64[:2], "single", "lazy13", 1)
    with pytest.raises(ValueError):
        ek.exp_tuple_chain(x64[:2], "tuple4", "mont12", 1)
    with pytest.raises(ValueError):
        ek.exp_ext_chain(x64[:2], x64[:2], x64[:2], "subs", 4, 1)
    with pytest.raises(ValueError):
        ek.exp_ext_chain(x64[:2], x64[:2], x64[:2], "mul", 12, 1)


@pytest.mark.parametrize("module,argv,n", [
    (exp_ab_mul, ["--device", "cpu", "--depth", "2", "--lanes", "4"], 4),
    (exp_carry, ["--device", "cpu", "--depth", "2", "--lanes", "4"], 3),
    (exp_truth, ["--device", "cpu", "--depths", "1", "2", "--lanes", "2"],
     1),
    (exp_addcost, ["--device", "cpu", "--depth", "1", "--lanes", "2"], 6),
], ids=["exp_ab_mul", "exp_carry", "exp_truth", "exp_addcost"])
def test_entry_points_on_cpu(module, argv, n, capsys):
    """Each entry point runs its plain versions with --device cpu, prints
    one JSON line a case, every one correct, and exits 0."""
    assert module.main(argv) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == n
    assert all(r["correct"] is True and r["device"] == "cpu"
               for r in lines)


def test_exp_carry_takes_tuple3_from_exp_ab_mul():
    """exp_carry's tuple3 is exp_ab_mul's mont12 launch: given that line,
    run() reports its time, `floored` and `correct` as tuple3's and times
    only serial and single; a line of another product or depth is
    refused."""
    mont12 = {"experiment": "exp_ab_mul", "product": "mont12", "depth": 2,
              "lanes": 4, "ns_an_iteration": 1234.5, "floored": True,
              "correct": True}
    lines = exp_carry.run("cpu", 2, 4, tuple3=mont12)
    t3 = next(r for r in lines if r["carry"] == "tuple3")
    assert t3["ns_an_iteration"] == pytest.approx(1234.5)
    assert (t3["floored"], t3["correct"]) == (True, True)
    assert [r["carry"] for r in lines] == list(exp_carry.KINDS)
    assert all(r["correct"] is True for r in lines)
    with pytest.raises(ValueError):
        exp_carry.run("cpu", 3, 4, tuple3=mont12)
    with pytest.raises(ValueError):
        exp_carry.run("cpu", 2, 4, tuple3={**mont12, "product": "lazy12"})
