"""The kernel of the point-op experiments (csrc/exp_point_kernels.cu), with
its plain PyTorch version, and Python-int models of its formulas.

- `exp_point_chain`: `depth` point operations a lane on three coordinates
  (the input's Jacobian words taken as the formula's coordinates, as the
  scripts take them), in a domain of DOMAINS, an op of OPS and a block of
  THREADS threads (POINT_CASES); replaces the point chains of
  scripts/exp_calib.py::projdbl, exp_width.py::projdbl,
  exp_pointops.py::chain_kernel and ::wstep_kernel_build, and
  exp_lazyops.py::chain_kernel and ::wstep_with_table.

Domains: "jac", canonical Jacobian dbl-2009-l and add-2007-bl with
point_add_tile's selects; "lazy", the complete RCB projective formulas in
the 13-word lazy domain (to_ext in, from_ext out); "ladder", the same RCB
formulas on canonical words (g1.cuh's, the ones K3 and g1_fft_stage run).
Ops: "double"; "add", p <- p + (p.y, p.x, p.z); "wstep", the window step:
a [1..8]P0 table of the input point P0 built first (jac: (k+1)P0 = kP0 +
P0 on the Jacobian add; lazy, ladder: from jac_to_proj(P0) on the RCB
add), then each step 4 doubles and an add of one entry (jac: entry 3 =
4P0; lazy, ladder: digit 5, entry 4 = 5P0).

The wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. Each launch adds one to
`LAUNCHES` and to its case in experiments.kernels.CASES
("exp_point_chain:lazy:double:64").

The plain versions: jac on curve/kernels.py's g1_double_plain and
g1_add_plain, an op at a time; ladder on its _Plain RCB formulas, reduced
once at the end; lazy on the 13-word limb engine of experiments/kernels.py
(lazy_mul_limbs and the lazy add and sub). All three are exact field
arithmetic, so their words equal the kernels' (the lazy domain's
from_ext ends on the canonical words). The Python-int models run the
same formulas (`rcb_double`, `rcb_add`, `jac_double`, `jac_add`,
`jac_to_proj`, written once over a field object) on MontField (canonical
Montgomery ints, R = 2^384) or LazyField (the kernel's 13-word lazy
integers, REDC over 2^416 and adds mod 2^416).
"""

from __future__ import annotations

import torch

from .. import build
from ..curve import kernels as gk
from ..curve.weierstrass import JacobianPoint
from ..field import limbs
from ..field.kernels import stream_of
from . import kernels as ek
from .kernels import CASES

LAUNCHES = {"exp_point_chain": 0}
DOMAINS = ("jac", "lazy", "ladder")
OPS = ("double", "add", "wstep")
THREADS = (64, 256, 512, 1024)
# every op at the experiments' 64 threads a block; the lazy and ladder
# doubles also at X8's 256, 512 and 1024
POINT_CASES = (tuple((d, o, 64) for d in DOMAINS for o in OPS)
               + tuple((d, "double", t) for d in ("lazy", "ladder")
                       for t in THREADS[1:]))
# the window step's table entry: jac 4P0 (exp_pointops.py:112-125), lazy
# and ladder the digit 5's 5P0 (exp_lazyops.py:99-105)
WSTEP_ENTRY = {"jac": 3, "lazy": 4, "ladder": 4}
FP = ek.FP
P = FP.modulus
R = 1 << 384
R_INV = pow(R, -1, P)
EXT_ONE = pow(2, 32 * ek.EXT_WORDS, P)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CASES.clear()


def _check_case(domain: str, op: str, threads: int) -> None:
    if (domain, op, threads) not in POINT_CASES:
        raise ValueError(f"exp_point_chain: case {domain!r}, {op!r}, "
                         f"{threads!r}")


# ---- the formulas, once, over a field object F (M, A, S, is_zero, where,
# b3_mul, one) ----
def rcb_add(F, p, q):
    """RCB15 Algorithm 7 (a = 0) in kzg_tpu/curve/pallas_g1.py's order."""
    M, A, S = F.M, F.A, F.S
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2 = M(x1, x2), M(y1, y2), M(z1, z2)
    t3 = M(A(x1, y1), A(x2, y2))
    t3 = S(t3, A(t0, t1))
    t4 = M(A(y1, z1), A(y2, z2))
    t4 = S(t4, A(t1, t2))
    x3 = M(A(x1, z1), A(x2, z2))
    y3 = S(x3, A(t0, t2))
    t0 = A(A(t0, t0), t0)
    t2 = F.b3_mul(t2)
    z3 = A(t1, t2)
    t1 = S(t1, t2)
    y3 = F.b3_mul(y3)
    x3 = S(M(t3, t1), M(t4, y3))
    y3 = A(M(t1, z3), M(y3, t0))
    z3 = A(M(z3, t4), M(t0, t3))
    return x3, y3, z3


def rcb_double(F, p):
    """RCB15 Algorithm 9 (a = 0) in pallas_g1.py's order."""
    M, A, S = F.M, F.A, F.S
    x, y, z = p
    t0 = M(y, y)
    z3 = A(t0, t0)
    z3 = A(z3, z3)
    z3 = A(z3, z3)
    t1 = M(y, z)
    t2 = F.b3_mul(M(z, z))
    x3 = M(t2, z3)
    y3 = A(t0, t2)
    z3 = M(t1, z3)
    t2 = A(A(t2, t2), t2)
    t0 = S(t0, t2)
    y3 = A(x3, M(t0, y3))
    x3 = M(t0, M(x, y))
    return A(x3, x3), y3, z3


def jac_to_proj(F, p):
    """Jacobian (X, Y, Z) -> projective (XZ : Y : Z^3); Z = 0 -> (0:1:0)
    in Y."""
    x, y, z = p
    return F.M(x, z), F.where(F.is_zero(z), F.one(y), y), \
        F.M(F.M(z, z), z)


def jac_double(F, p):
    """dbl-2009-l (a = 0) in g1_jac.cuh's order (point_double_tile's)."""
    M, A, S = F.M, F.A, F.S
    x, y, z = p
    a, b = M(x, x), M(y, y)
    c = M(b, b)
    t = A(x, b)
    d = S(M(t, t), A(a, c))
    d = A(d, d)
    e = A(A(a, a), a)
    x3 = S(M(e, e), A(d, d))
    c = A(c, c)
    c = A(c, c)
    c = A(c, c)
    y3 = S(M(e, S(d, x3)), c)
    t = M(y, z)
    return x3, y3, A(t, t)


def jac_add(F, p, q):
    """add-2007-bl with point_add_tile's selects, for one lane (Python
    ints): P at infinity -> Q, Q at infinity -> P, the double where
    P == Q, all-zero words where P == -Q."""
    M, A, S = F.M, F.A, F.S
    x1, y1, z1 = p
    x2, y2, z2 = q
    if F.is_zero(z1):
        return q
    if F.is_zero(z2):
        return p
    z1z1, z2z2 = M(z1, z1), M(z2, z2)
    u1, u2 = M(x1, z2z2), M(x2, z1z1)
    s1, s2 = M(M(y1, z2), z2z2), M(M(y2, z1), z1z1)
    h, rr = S(u2, u1), S(s2, s1)
    if F.is_zero(h):
        return jac_double(F, p) if F.is_zero(rr) else (F.zero(),) * 3
    t = A(h, h)
    i2 = M(t, t)
    j = M(h, i2)
    rr = A(rr, rr)
    v = M(u1, i2)
    x3 = S(M(rr, rr), A(j, A(v, v)))
    s1 = M(s1, j)
    y3 = S(M(rr, S(v, x3)), A(s1, s1))
    t = A(z1, z2)
    z3 = M(S(M(t, t), A(z1z1, z2z2)), h)
    return x3, y3, z3


# ---- Python-int fields ----
class MontField:
    """Canonical Montgomery ints mod p, R = 2^384: the jac and ladder
    kernels' words."""

    def M(self, a, b):
        return a * b * R_INV % P

    def A(self, a, b):
        return (a + b) % P

    def S(self, a, b):
        return (a - b) % P

    def b3_mul(self, a):
        return 12 * a % P

    def is_zero(self, a):
        return a == 0

    def where(self, cond, a, b):
        return a if cond else b

    def one(self, like):
        return R % P

    def zero(self):
        return 0


class LazyField(MontField):
    """The lazy kernel's 13-word integers: REDC over 2^416 with no
    conditional subtraction, adds and a + (K m - b) mod 2^416. `audit`
    keeps the largest subtrahend and operand seen, and the subs that
    wrapped below zero."""

    MASK = (1 << (32 * ek.EXT_WORDS)) - 1

    def __init__(self):
        self.audit = {"subtrahend": 0, "operand": 0, "wrapped": 0}

    def M(self, a, b):
        self.audit["operand"] = max(self.audit["operand"], a, b)
        return ek.redc_int(a * b, ek.EXT_WORDS)

    def A(self, a, b):
        return (a + b) & self.MASK

    def S(self, a, b):
        self.audit["subtrahend"] = max(self.audit["subtrahend"], b)
        if b > a + ek.EXT_KM:
            self.audit["wrapped"] += 1
        return (a + ek.EXT_KM - b) & self.MASK

    def b3_mul(self, a):
        x2 = self.A(a, a)
        x4 = self.A(x2, x2)
        return self.A(self.A(x4, x4), x4)

    def one(self, like):
        return EXT_ONE

    def to_ext(self, v):
        return self.M(v, ek.EXT_C_IN)

    def from_ext(self, v):
        r = ek.redc_int(v * ek.EXT_C_OUT, ek.EXT_WORDS)
        return r - P if r >= P else r


def _chain(F, domain: str, op: str, p, depth: int):
    """The kernel's chain on one lane, its formulas on the field F."""
    if domain == "jac":
        dbl = lambda q: jac_double(F, q)           # noqa: E731
        add = lambda a, b: jac_add(F, a, b)        # noqa: E731
        base = p
    else:
        dbl = lambda q: rcb_double(F, q)           # noqa: E731
        add = lambda a, b: rcb_add(F, a, b)        # noqa: E731
        base = jac_to_proj(F, p) if op == "wstep" else p
    if op == "double":
        for _ in range(depth):
            p = dbl(p)
    elif op == "add":
        for _ in range(depth):
            p = add(p, (p[1], p[0], p[2]))
    else:
        tbl = [base]
        for _ in range(7):
            tbl.append(add(tbl[-1], base))
        sel = tbl[WSTEP_ENTRY[domain]]
        for _ in range(depth):
            for _ in range(4):
                p = dbl(p)
            p = add(p, sel)
    return p


def chain_int(domain: str, op: str, point, depth: int) -> tuple:
    """The kernel's output words for one lane as Python ints: `point` the
    input's (x, y, z) Montgomery ints."""
    if domain == "lazy":
        F = LazyField()
        out = _chain(F, domain, op, tuple(F.to_ext(v) for v in point), depth)
        return tuple(F.from_ext(v) for v in out)
    return tuple(_chain(MontField(), domain, op, tuple(point), depth))


def lazy_audit(op: str, point, depth: int) -> dict:
    """LazyField's audit of the lazy chain on one lane (lazy.cuh's header:
    every subtrahend below 37p, no sub wrapping)."""
    F = LazyField()
    _chain(F, "lazy", op, tuple(F.to_ext(v) for v in point), depth)
    return F.audit


# ---- plain versions ----
class _LazyLimbs:
    """The 13-word lazy domain on the limb engine (experiments/kernels.py):
    (lanes, 26) canonical 16-bit limbs."""

    def __init__(self, device):
        self.one_limbs = torch.tensor(
            limbs.int_to_limbs(EXT_ONE, 2 * ek.EXT_WORDS),
            dtype=torch.int64, device=device)

    def M(self, a, b):
        return ek.lazy_mul_limbs(a, b, ek.EXT_WORDS)

    def A(self, a, b):
        return ek._ext_op_plain("adds", a, b)

    def S(self, a, b):
        return ek._ext_op_plain("subs", a, b)

    def b3_mul(self, a):
        x2 = self.A(a, a)
        x4 = self.A(x2, x2)
        return self.A(self.A(x4, x4), x4)

    def is_zero(self, a):
        return (a == 0).all(dim=-1, keepdim=True)

    def where(self, cond, a, b):
        return torch.where(cond, a, b)

    def one(self, like):
        return self.one_limbs.expand(like.shape)


def _plain_lazy(x, y, z, op: str, depth: int) -> tuple:
    F = _LazyLimbs(x.device)
    c_in, c_out, _ = ek._ext_consts(x.device)
    p = tuple(F.M(ek._padded(c, ek.EXT_WORDS), c_in) for c in (x, y, z))
    out = _chain(F, "lazy", op, p, depth)
    return tuple(limbs.limbs_to_words(ek.cond_sub_limbs(
        F.M(v, c_out), ek.EXT_WORDS)[..., :24]) for v in out)


def _plain_ladder(x, y, z, op: str, depth: int) -> tuple:
    pl = gk._plain(x.device)
    p = tuple(limbs.words_to_limbs(c) for c in (x, y, z))
    if op == "double":
        for _ in range(depth):
            p = pl.proj_double(p)
    elif op == "add":
        for _ in range(depth):
            p = pl.proj_add(p, (p[1], p[0], p[2]))
    else:
        tbl = pl.table(pl.jac_to_proj(JacobianPoint(x, y, z)))
        sel = tuple(tbl[WSTEP_ENTRY["ladder"], c] for c in range(3))
        for _ in range(depth):
            for _ in range(4):
                p = pl.proj_double(p)
            p = pl.proj_add(p, sel)
    return tuple(pl.words(v) for v in p)


def _plain_jac(x, y, z, op: str, depth: int) -> tuple:
    p = JacobianPoint(x, y, z)
    if op == "double":
        for _ in range(depth):
            p = gk.g1_double_plain(p)
    elif op == "add":
        for _ in range(depth):
            p = gk.g1_add_plain(p, JacobianPoint(p.y, p.x, p.z))
    else:
        tbl = [p]
        for _ in range(7):
            tbl.append(gk.g1_add_plain(tbl[-1], tbl[0]))
        sel = tbl[WSTEP_ENTRY["jac"]]
        for _ in range(depth):
            for _ in range(4):
                p = gk.g1_double_plain(p)
            p = gk.g1_add_plain(p, sel)
    return tuple(p)


def exp_point_chain_plain(x, y, z, domain: str, op: str, depth: int,
                          threads: int = 64) -> tuple:
    _check_case(domain, op, threads)
    fn = {"jac": _plain_jac, "lazy": _plain_lazy,
          "ladder": _plain_ladder}[domain]
    return fn(x, y, z, op, depth)


# ---- the wrapper ----
def exp_point_chain(x, y, z, domain: str, op: str, depth: int,
                    threads: int = 64) -> tuple:
    """`depth` ops of `op` a lane in `domain` on (lanes, 12) Fp Montgomery
    words of three coordinates, a block of `threads` threads; returns the
    three coordinates' words (module docstring)."""
    if x.device.type == "cpu":
        return exp_point_chain_plain(x, y, z, domain, op, depth, threads)
    _check_case(domain, op, threads)
    n = ek._lanes(x, 12, "exp_point_chain")
    for t in (y, z):
        if t.shape != x.shape or t.device != x.device \
                or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("exp_point_chain: y and z must match x")
    if depth < 0:
        raise ValueError("exp_point_chain: depth < 0")
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if n:
        lib = build.library("exp_point_kernels")
        LAUNCHES["exp_point_chain"] += 1
        CASES[f"exp_point_chain:{domain}:{op}:{threads}"] += 1
        build.check(lib.kzg_exp_point_chain(
            DOMAINS.index(domain), OPS.index(op), threads,
            *(o.data_ptr() for o in outs), x.data_ptr(), y.data_ptr(),
            z.data_ptr(), n, depth, stream_of(x)), "exp_point_chain")
    return outs


# ---- what the entry points share ----
CHECK_LANES = (0, 1, 63)
# Fp products an op, by the formulas: RCB double 8, add 12; Jacobian
# double 7, add 16 (its generic branch); a window step 4 doubles and an add
PRODUCTS_AN_OP = {("jac", "double"): 7, ("jac", "add"): 16,
                  ("jac", "wstep"): 44, ("lazy", "double"): 8,
                  ("lazy", "add"): 12, ("lazy", "wstep"): 44,
                  ("ladder", "double"): 8, ("ladder", "add"): 12,
                  ("ladder", "wstep"): 44}


def check_lanes(pts, outs, domain: str, op: str, depth: int,
                lanes=CHECK_LANES) -> bool:
    """The kernel's words on a few lanes against chain_int."""
    from .exp_montmul import word_ints

    lanes = [i for i in lanes if i < pts[0].shape[0]]
    ins = list(zip(*(word_ints(c, lanes) for c in pts)))
    got = list(zip(*(word_ints(c, lanes) for c in outs)))
    return got == [chain_int(domain, op, p, depth) for p in ins]


def loop_time(step, args, chain: bool = False):
    """(seconds a call, floored, the last output) of step(*args):
    utils.benchloop.device_loop's slope of 1 to 5 calls, the device held
    while the host enqueues them; on the CPU, where the entry points only
    rehearse, one window of each instead of the best of three."""
    from ..utils.benchloop import device_loop

    windows = 3 if args[0].is_cuda else 1
    sec, out, floored = device_loop(step, args, k=4, chain=chain,
                                    windows=windows, hold=True)
    return sec, floored, out


def time_chain(pts, domain: str, op: str, depth: int, threads: int = 64):
    """(seconds a launch, floored, the output of one launch), on the same
    inputs each launch."""
    def step(x, y, z):
        return exp_point_chain(x, y, z, domain, op, depth, threads)

    sec, floored, _ = loop_time(step, pts)
    return sec, floored, step(*pts)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
