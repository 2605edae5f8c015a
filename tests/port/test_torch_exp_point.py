"""The point-op experiments (kzg_tpu_torch.experiments: exp_calib,
exp_bisect, exp_width, exp_pointops, exp_lazyops) on the CPU: the plain
versions of exp_point_chain, exp_tuple_chain's transp, serial8 and serial1
(mont12, sqr12) and exp_ext_body against the JAX package's recorded
outputs on the scripts' inputs (tests/port/make_reference.py, group
exp_point) wherever both compute the same integer, and against Python-int
models of the kernels' arithmetic, exactly. Nothing here compiles JAX.

Every point chain and exp_ext_body's conv, indep8 and dblshape end on
from_ext's canonical words, and the canonical chains (jac, ladder,
serial8, serial1) on canonical words, so they equal their records word
for word (the TPU's lazy domain is REDC over 2^400, the port's over
2^416: the same field elements). Where the two compute different integers
the record is held to a model of the TPU's arithmetic and the port to its
own:
- transp runs the script's 25 rows with its n' = -p^-1 mod 2^384 padded
  with a zero row, which is not REDC;
- ctx is true REDC on both sides, so each output of the port is the
  record's times 2^(-16 e) mod p, e the output's R-exponent, tracked
  through the body on the host.
"""

import json

import numpy as np
import pytest
import torch

import port_helpers as ph
from kzg_tpu_torch import convert
from kzg_tpu_torch.experiments import (exp_ab_mul, exp_addcost, exp_bisect,
                                       exp_calib, exp_lazyops, exp_pointops,
                                       exp_width)
from kzg_tpu_torch.experiments import kernels as ek
from kzg_tpu_torch.experiments import point_kernels as pk
from kzg_tpu_torch.experiments.exp_montmul import word_ints

CPU = ph.CPU
# the recorder's depth and lanes (make_reference.EXP_DEPTH)
DEPTH = 8
LANES = 64
P = ek.FP.modulus
FULL_LANES = 3
# each script's points: (seed, 40-byte values drawn first)
SCRIPT_POINTS = {"calib": (3, 64), "bisect": (3, 64), "width": (3, 0),
                 "pointops": (9, 0), "lazyops": (9, 0)}


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
def points():
    return {name: exp_addcost.inputs(LANES, CPU, seed, skip)
            for name, (seed, skip) in SCRIPT_POINTS.items()}


def recorded(key, pts):
    return ph.reference(key, *(lane_limbs(c) for c in pts), DEPTH)


POINT_RECORDS = [
    ("calib:projdbl", "calib", "lazy", "double"),
    ("calib:projdbl", "calib", "ladder", "double"),
    ("width:projdbl", "width", "lazy", "double"),
    ("width:projdbl", "width", "ladder", "double"),
    ("pointops:double", "pointops", "jac", "double"),
    ("pointops:add", "pointops", "jac", "add"),
    ("pointops:wstep", "pointops", "jac", "wstep"),
    ("lazyops:proj_double", "lazyops", "lazy", "double"),
    ("lazyops:proj_double", "lazyops", "ladder", "double"),
    ("lazyops:proj_add", "lazyops", "lazy", "add"),
    ("lazyops:proj_add", "lazyops", "ladder", "add"),
    ("lazyops:wstep", "lazyops", "lazy", "wstep"),
    ("lazyops:wstep", "lazyops", "ladder", "wstep")]


@pytest.mark.parametrize("key,script,domain,op", POINT_RECORDS,
                         ids=[f"{k}-{d}" for k, _, d, _ in POINT_RECORDS])
def test_point_chain_vs_recorded(points, key, script, domain, op):
    """X3's, X8's, X9's and X10's point chains at depth 8 on 64 of each
    script's points: the plain version equals the recorded TPU chain
    (interpreted where the script's site is a pl.pallas_call) word for
    word, and the Python-int model."""
    pts = points[script]
    got = pk.exp_point_chain(*pts, domain, op, DEPTH)
    rec = recorded(f"exp_point:{key}", pts)
    for g, r in zip(got, rec):
        assert np.array_equal(lane_limbs(g), r)
    assert pk.check_lanes(pts, got, domain, op, DEPTH, range(0, LANES, 9))


@pytest.mark.parametrize("op", pk.OPS)
def test_ladder_equals_lazy(points, op):
    """The ladder domain (canonical RCB) gives the lazy domain's words,
    and so do their Python-int models on every lane."""
    pts = points["lazyops"]
    lazy = pk.exp_point_chain(*pts, "lazy", op, DEPTH)
    ladder = pk.exp_point_chain(*pts, "ladder", op, DEPTH)
    assert all(torch.equal(a, b) for a, b in zip(lazy, ladder))
    ins = list(zip(*(ints(c[:8]) for c in pts)))
    assert [pk.chain_int("lazy", op, p, DEPTH) for p in ins] == \
        [pk.chain_int("ladder", op, p, DEPTH) for p in ins]


FULL_CASES = [(d, o) for d in pk.DOMAINS for o in pk.OPS]


@pytest.mark.parametrize("domain,op", FULL_CASES,
                         ids=[f"{d}-{o}" for d, o in FULL_CASES])
def test_point_chain_full_depth(points, domain, op):
    """Every domain and op of the kernel at the scripts' 64 steps on 3
    lanes: the plain version against the Python-int model."""
    pts = tuple(c[:FULL_LANES] for c in points["lazyops"])
    got = pk.exp_point_chain_plain(*pts, domain, op, exp_pointops.DEPTH)
    assert pk.check_lanes(pts, got, domain, op, exp_pointops.DEPTH)


class CountingField(pk.MontField):
    def __init__(self):
        self.zeros = 0

    def is_zero(self, a):
        self.zeros += a == 0
        return a == 0


def test_jac_add_edge_lanes(points):
    """The Jacobian add on a lane with x = y (h = 0 and r = 0: the double
    branch) and one with z = 0 (P at infinity: Q, then the swap of its
    coordinates) beside generic lanes: the plain version equals the model,
    which takes both selects."""
    x, y, z = (c[:4].clone() for c in points["pointops"])
    y[1] = x[1]
    z[2] = 0
    got = pk.exp_point_chain(x, y, z, "jac", "add", 3)
    assert pk.check_lanes((x, y, z), got, "jac", "add", 3, range(4))
    for lane in (1, 2):
        F = CountingField()
        pt = tuple(ints(c[lane:lane + 1])[0] for c in (x, y, z))
        pk.jac_add(F, pt, (pt[1], pt[0], pt[2]))
        assert F.zeros >= 1
    F = CountingField()
    pt = tuple(ints(c[1:2])[0] for c in (x, y, z))
    z1z1 = F.M(pt[2], pt[2])
    assert F.S(F.M(pt[0], z1z1), F.M(pt[1], z1z1)) == 0


@pytest.mark.parametrize("op,bound", [("double", 37), ("add", 13),
                                      ("wstep", 37)])
def test_lazy_audit(points, op, bound):
    """lazy.cuh's audit on 8 lanes of the scripts' points at the scripts'
    64 steps: every lazy sub's subtrahend below 37p in a double, 13p in an
    add, so below K m = 64p; no sub wraps; every product's operand below
    2^35 p."""
    for pt in zip(*(ints(c[:8]) for c in points["lazyops"])):
        audit = pk.lazy_audit(op, pt, exp_lazyops.DEPTH)
        assert audit["subtrahend"] < bound * P
        assert audit["wrapped"] == 0
        assert audit["operand"] < P << 35


@pytest.mark.parametrize("key,body,product", [
    ("width:serial8", "serial8", "mont12"),
    ("pointops:mul", "serial1", "mont12"),
    ("pointops:sqr", "serial1", "sqr12")])
def test_serial_bodies_vs_recorded(points, key, body, product):
    """X8's serial8 and X9's mul and sqr chains on the scripts' x
    coordinates: the plain version equals the record and the model."""
    x = points["width" if body == "serial8" else "pointops"][0]
    got = ek.exp_tuple_chain(x, body, product, DEPTH)
    rec = ph.reference(f"exp_point:{key}", lane_limbs(x), DEPTH)
    assert np.array_equal(lane_limbs(got), rec)
    assert ints(got) == [exp_ab_mul.body_int(product, v, DEPTH, body)
                         for v in ints(x)]


def test_sqr12_equals_mont12():
    """The symmetric square's plain version equals mont12(x, x) at the
    ends of the range and on random values below p, and the model's
    canonical product."""
    rng = np.random.default_rng(5)
    vals = [0, 1, 2, P - 1, P - 2, (1 << 383) % P] + ph.random_ints(rng, 10,
                                                                     P)
    x = ek.FP.encode(vals, CPU)
    v = ek._padded(x, 12)
    sq = ek._tuple_product("sqr12")(v, v)
    mm = ek._tuple_product("mont12")(v, v)
    assert torch.equal(sq, mm)
    assert [int(sum(int(l) << (16 * k) for k, l in enumerate(r)))
            for r in sq.tolist()] == [
        exp_ab_mul.product_int("mont12", a, a) for a in ints(x)]


@pytest.mark.parametrize("body,product", ek.TUPLE_CASES_X789,
                         ids=[f"{b}-{p}" for b, p in ek.TUPLE_CASES_X789])
def test_tuple_bodies_full_depth(points, body, product):
    """The new bodies at the scripts' 64 iterations on 3 lanes against the
    models."""
    pts = tuple(c[:FULL_LANES] for c in points["bisect"])
    if body == "transp":
        got = ek.exp_tuple_chain_plain(exp_bisect.word_major(pts), body,
                                       product, exp_bisect.DEPTH)
        assert got.shape == (12, FULL_LANES)
        assert ints(got.T) == [
            exp_bisect.body_int("transp", pt, exp_bisect.DEPTH)[0]
            for pt in zip(*(ints(c) for c in pts))]
        return
    got = ek.exp_tuple_chain_plain(pts[0], body, product, exp_bisect.DEPTH)
    assert exp_ab_mul.check_lanes(pts[0], got, product, exp_bisect.DEPTH,
                                  body, range(FULL_LANES))


def script_lazy_int(t: int, rows: int, nprime: int) -> int:
    """lazy_mul_tile at `rows` 16-bit rows with the constant `nprime`."""
    bits = 16 * rows
    mask = (1 << bits) - 1
    q = (t * nprime) & mask
    return ((t + q * P) >> bits) & mask


def script_seven(pt, nprime: int, depth: int = DEPTH) -> tuple:
    return exp_bisect_seven(lambda a, b: script_lazy_int(a * b, 25, nprime),
                            pt, depth)


def exp_bisect_seven(M, pt, depth):
    v = tuple(pt)
    for _ in range(depth):
        v = exp_bisect.body_step("conv", M, v)
    return v


def test_transp_vs_models(points):
    """X7's transp: the record is the script's 25-row arithmetic with its
    zero-padded n' (not REDC), the port's plain version its own model
    (REDC over 2^416), and the two differ on every lane."""
    pts = points["bisect"]
    rec = ph.reference("exp_point:bisect:transp",
                       *(lane_limbs(c) for c in pts), DEPTH)
    ins = list(zip(*(ints(c) for c in pts)))
    want = [script_seven(pt, ek.FP.nprime) for pt in ins]
    assert list(zip(*(limb_ints(r) for r in rec))) == want
    got = ek.exp_tuple_chain(exp_bisect.word_major(pts), "transp", "lazy13",
                             DEPTH)
    port = ints(got.T.contiguous())
    assert port == [exp_bisect.body_int("transp", pt, DEPTH)[0]
                    for pt in ins]
    assert all(a != w[0] for a, w in zip(port, want))


def test_ctx_vs_recorded_relation(points):
    """X7's ctx: both sides are true REDC (the record over 2^400 on
    _kernel_ctx's n', the port over 2^416 on the modulus read into
    registers), so the record equals its REDC model and each port output
    is the record's times 2^(-16 e) mod p, e its R-exponent."""
    pts = points["bisect"]
    rec = ph.reference("exp_point:bisect:ctx",
                       *(lane_limbs(c) for c in pts), DEPTH)
    ins = list(zip(*(ints(c) for c in pts)))
    r400 = 1 << 400
    npr400 = (-pow(P, -1, r400)) % r400
    assert list(zip(*(limb_ints(r) for r in rec))) == [
        script_seven(pt, npr400) for pt in ins]
    exps = exp_bisect_seven(lambda a, b: a + b + 1, (0, 0, 0), DEPTH)
    got = ek.exp_ext_body(*pts, "ctx", DEPTH)
    port = list(zip(*(ints(c) for c in got)))
    assert port == [exp_bisect.body_int("ctx", pt, DEPTH) for pt in ins]
    for lane, rec_lane in zip(port, zip(*(limb_ints(r) for r in rec))):
        for v, r, e in zip(lane, rec_lane, exps):
            assert v % P == r * pow(2, -16 * e, P) % P


@pytest.mark.parametrize("key,body,script", [
    ("bisect:conv", "conv", "bisect"),
    ("lazyops:mulref_indep", "indep8", "lazyops"),
    ("lazyops:mulref_chain", "dblshape", "lazyops")])
def test_ext_body_vs_recorded(points, key, body, script):
    """X7's conv and X10's mulref chains end on from_ext's canonical
    words: the plain version equals the record word for word, and the
    model."""
    pts = points[script]
    got = ek.exp_ext_body(*pts, body, DEPTH)
    rec = recorded(f"exp_point:{key}", pts)
    for g, r in zip(got, rec):
        assert np.array_equal(lane_limbs(g), r)
    assert exp_bisect.check_body_lanes(pts, got, body, DEPTH,
                                       range(0, LANES, 7))


@pytest.mark.parametrize("body", ek.EXT_BODIES)
def test_ext_body_full_depth(points, body):
    pts = tuple(c[:FULL_LANES] for c in points["bisect"])
    got = ek.exp_ext_body_plain(*pts, body, exp_bisect.DEPTH)
    assert exp_bisect.check_body_lanes(pts, got, body, exp_bisect.DEPTH)


def test_glv_products():
    """K4's product count: 120 outside the ladder, 32 a window below the
    top nonzero one, 12 an add, 13 a phi add."""
    d1 = np.zeros((3, 33), np.int32)
    d2 = np.zeros((3, 33), np.int32)
    d1[1, 0] = 3
    d1[2, 5], d2[2, 2], d2[2, 0] = 1, -2, 7
    assert exp_calib.glv_products(d1, d2).tolist() == [
        120, 120 + 12, 120 + 32 * 5 + 12 + 2 * 13]


def test_cases_and_rejects(points):
    """The kernel's cases: every op at 64 threads, the lazy and ladder
    doubles also at 256, 512 and 1024 (the same words); the wrappers
    refuse the rest."""
    assert len(pk.POINT_CASES) == 15
    pts = tuple(c[:2] for c in points["lazyops"])
    for domain in ("lazy", "ladder"):
        want = pk.exp_point_chain(*pts, domain, "double", 2)
        for threads in pk.THREADS[1:]:
            got = pk.exp_point_chain(*pts, domain, "double", 2, threads)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        pk.exp_point_chain(*pts, "jac", "double", 1, 256)
    with pytest.raises(ValueError):
        pk.exp_point_chain(*pts, "lazy", "wstep", 1, 1024)
    with pytest.raises(ValueError):
        pk.exp_point_chain(*pts, "proj", "double", 1)
    with pytest.raises(ValueError):
        ek.exp_ext_body(*pts, "seven", 1)
    with pytest.raises(ValueError):
        ek.exp_tuple_chain(pts[0], "serial8", "lazy13", 1)


@pytest.mark.parametrize("module,n", [
    (exp_calib, 4), (exp_bisect, 4), (exp_width, 10), (exp_pointops, 5),
    (exp_lazyops, 5)], ids=["exp_calib", "exp_bisect", "exp_width",
                            "exp_pointops", "exp_lazyops"])
def test_entry_points_on_cpu(module, n, capsys):
    """Each entry point runs its plain versions with --device cpu, prints
    one JSON line a case, every one correct, and exits 0."""
    argv = ["--device", "cpu", "--depth", "1", "--lanes", "2"]
    assert module.main(argv) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == n
    assert all(r["correct"] is True and r["device"] == "cpu"
               for r in lines)
