"""G1 ladder kernels K3 (`g1_scalar_mul`) and K4 (`g1_glv_butterfly`),
the G1 FFT stage kernel `g1_fft_stage`, the window tables
(`g1_window_table`) and the fixed-base product (`g1_fixed_base_mul`),
the row sums `g1_sum` and `g1_horner`, and the point kernels `g1_add`
and `g1_double`, with their plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel (csrc/g1_kernels.cu, g1_fft_kernels.cu,
g1_table_kernels.cu, g1_sum_kernels.cu, g1_point_kernels.cu) or raises.
Each launch adds one to the wrapper's entry in `LAUNCHES`.

The ladders run the complete Renes-Costello-Batina projective formulas
(a = 0, b3 = 12) in the operation order of kzg_tpu/curve/pallas_g1.py,
with Jacobian points in and out. Infinity enters as any Z == 0 and leaves
as all-zero words. Window tables hold projective points as canonical
words, (..., W, 8, 36): entry m of window w of base B is (m+1) 16^w B,
x, y and z of 12 words each. The plain versions run the same formulas in
the same order on the redundant int64 engine (field/limbs.py) and reduce
once at the end, so their output words equal the kernels'.

`g1_add` and `g1_double` are the complete Jacobian formulas of
kzg_tpu/curve/pallas_g1.py (add-2007-bl with its selects, dbl-2009-l), on
Jacobian words in and out. Their plain versions also run on the redundant
engine and canonicalise only the outputs and the two values the selects
test (h and r).
"""

from __future__ import annotations

import functools
import math

import torch

from .. import build
from ..field import fp, limbs
from ..field.kernels import check_words, stream_of
from .glv import GLV_BETA
from .weierstrass import JacobianPoint

LAUNCHES = {"g1_scalar_mul": 0, "g1_glv_butterfly": 0, "g1_add": 0,
            "g1_double": 0, "g1_window_table": 0, "g1_fft_stage": 0,
            "g1_fixed_base_mul": 0, "g1_sum": 0, "g1_horner": 0}

NP = fp.N_WORDS
PW = 3 * NP         # words of a projective point
FIXED_WINDOWS = 64  # signed 4-bit windows of an Fr scalar
FIXED_PARTS = 8     # threads (window groups) per lane of the fixed-base sum
STAGE_THREADS = 128
SUM_THREADS = 128   # threads of a g1_sum block
SUM_RUN = 4         # consecutive points a g1_sum thread adds in a chain
TABLE_SMEM_WORDS = 8 * PW + 4   # a staged [1..8] table with its pad


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain version: RCB formulas on the redundant int64 engine ----
# the most lanes a product of the plain point formulas has where their
# independent products share one engine call
PLAIN_BATCH_LANES = 32


class _Plain:
    def __init__(self, device):
        self.c = limbs.consts(fp.SPEC, device)
        L = fp.SPEC.n_limbs
        self.one = torch.tensor(limbs.int_to_limbs(fp.SPEC.one_mont, L),
                                dtype=torch.int64, device=device)
        self.beta = torch.tensor(
            limbs.int_to_limbs(fp.SPEC.to_mont_int(GLV_BETA), L),
            dtype=torch.int64, device=device)

    def M(self, a, b):
        return limbs.mul_lazy(self.c, a, b)

    def Ms(self, *pairs):
        """Independent products, in one engine call where they have few
        lanes (there the per-call cost dominates; on many lanes one call
        a product keeps each call's operands in cache). The engine works
        lane by lane, so each equals its own M(a, b) limb for limb."""
        shape = torch.broadcast_shapes(*(t.shape for ab in pairs
                                         for t in ab))
        if math.prod(shape[:-1]) > PLAIN_BATCH_LANES:
            return tuple(self.M(a, b) for a, b in pairs)
        a = torch.stack([x.expand(shape) for x, _ in pairs])
        b = torch.stack([y.expand(shape) for _, y in pairs])
        return self.M(a, b).unbind(0)

    def proj_add(self, p, q):
        """RCB15 Algorithm 7 (a = 0), its products in two tiers."""
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0, t1, t2, t3, t4, y3 = self.Ms(
            (x1, x2), (y1, y2), (z1, z2), (x1 + y1, x2 + y2),
            (y1 + z1, y2 + z2), (x1 + z1, x2 + z2))
        t3 = t3 - (t0 + t1)
        t4 = t4 - (t1 + t2)
        y3 = y3 - (t0 + t2)
        t0 = 3 * t0
        t2 = 12 * t2
        z3 = t1 + t2
        t1 = t1 - t2
        y3 = 12 * y3
        a, b, c, d, e, f = self.Ms((t3, t1), (t4, y3), (t1, z3), (y3, t0),
                                   (z3, t4), (t0, t3))
        return a - b, c + d, e + f

    def proj_double(self, p):
        """RCB15 Algorithm 9 (a = 0), its products in two tiers."""
        x, y, z = p
        t0, t1, zz, xy = self.Ms((y, y), (y, z), (z, z), (x, y))
        z3 = 8 * t0
        t2 = 12 * zz
        y3 = t0 + t2
        t0 = t0 - 3 * t2
        x3, z3, ty, tx = self.Ms((t2, z3), (t1, z3), (t0, y3), (t0, xy))
        return 2 * tx, x3 + ty, z3

    def jac_to_proj(self, p: JacobianPoint):
        """Jacobian words -> projective (XZ : Y : Z^3); Z = 0 -> (0:1:0)."""
        inf = fp.is_zero(p.z).unsqueeze(-1)
        x, y, z = (limbs.words_to_limbs(c) for c in p)
        return (self.M(x, z), torch.where(inf, self.one, y),
                self.M(self.M(z, z), z))

    def words(self, v):
        """Lazy limbs -> canonical words."""
        return limbs.limbs_to_words(limbs.canon_wide(self.c, v))

    def tree_sum(self, acc, r: int):
        """(x, y, z) of (..., r, L) -> the sum over r in the kernels' fixed
        order: item j += item j + s for s = r/2, ..., 1."""
        s = r >> 1
        while s:
            head = tuple(c[..., :s, :] for c in acc)
            tail = tuple(c[..., s:2 * s, :] for c in acc)
            acc = self.proj_add(head, tail)
            s >>= 1
        return tuple(c[..., 0, :] for c in acc)

    def to_jac(self, p) -> JacobianPoint:
        """Projective -> canonical Jacobian words (XZ, YZ^2, Z). Z may be
        a sum of two lazy products, up to 4m, so every coordinate takes
        the wide reduction (at infinity Z is 0, not m)."""
        x, y, z = p
        return JacobianPoint(*(self.words(v) for v in
                               (self.M(x, z), self.M(y, self.M(z, z)), z)))

    def identity(self, like):
        zero = torch.zeros_like(like)
        return zero, self.one.expand(like.shape).clone(), zero.clone()

    def table(self, p):
        """(8, 3, n, L) stack of [1..8]P, (k+1)P = kP + P."""
        tbl = [p]
        for _ in range(7):
            tbl.append(self.proj_add(tbl[-1], p))
        return torch.stack([torch.stack(t) for t in tbl])

    def apply_digit(self, acc, tbl, d, phi: bool):
        """acc += sign(d) tbl[|d|-1] (x scaled by beta if phi); d == 0
        leaves acc as it is."""
        lanes = torch.arange(d.shape[0], device=d.device)
        idx = (d.abs() - 1).clamp(min=0).long()
        sx, sy, sz = tbl[idx, :, lanes].unbind(1)
        sy = torch.where((d < 0).unsqueeze(-1), -sy, sy)
        if phi:
            sx = self.M(sx, self.beta)
        added = self.proj_add(acc, (sx, sy, sz))
        keep = (d == 0).unsqueeze(-1)
        return tuple(torch.where(keep, a, b) for a, b in zip(acc, added))

    def ladder(self, base, digit_rows):
        """sum over (digits, phi) rows of the Horner ladder on `base`."""
        return self.ladder_on(self.table(base), digit_rows)

    def ladder_on(self, tbl, digit_rows):
        """The Horner ladder on a (8, 3, n, L) table of [1..8]P."""
        acc = self.identity(tbl[0, 0])
        n_windows = digit_rows[0][0].shape[-1]
        for w in range(n_windows - 1, -1, -1):
            for _ in range(4):
                acc = self.proj_double(acc)
            for dig, phi in digit_rows:
                acc = self.apply_digit(acc, tbl, dig[:, w], phi)
        return acc


@functools.lru_cache(maxsize=None)
def _plain(device) -> _Plain:
    return _Plain(torch.device(device))


def _flat(p: JacobianPoint) -> JacobianPoint:
    return JacobianPoint(*(c.reshape(-1, NP) for c in p))


def _shaped(p: JacobianPoint, shape) -> JacobianPoint:
    return JacobianPoint(*(c.reshape(tuple(shape) + (NP,)) for c in p))


def g1_scalar_mul_plain(p: JacobianPoint, digits) -> JacobianPoint:
    shape = p.x.shape[:-1]
    pl = _plain(p.x.device)
    dig = digits.reshape(-1, digits.shape[-1])
    acc = pl.ladder(pl.jac_to_proj(_flat(p)), [(dig, False)])
    return _shaped(pl.to_jac(acc), shape)


def g1_glv_butterfly_plain(a: JacobianPoint, b: JacobianPoint, d1, d2):
    shape = a.x.shape[:-1]
    pl = _plain(a.x.device)
    t = pl.ladder(pl.jac_to_proj(_flat(b)),
                  [(d1.reshape(-1, d1.shape[-1]), False),
                   (d2.reshape(-1, d2.shape[-1]), True)])
    ap = pl.jac_to_proj(_flat(a))
    lo = pl.to_jac(pl.proj_add(ap, t))
    hi = pl.to_jac(pl.proj_add(ap, (t[0], -t[1], t[2])))
    return _shaped(lo, shape), _shaped(hi, shape)


def _table_limbs(tables: torch.Tensor) -> torch.Tensor:
    """(n, 8, 36) words -> (8, 3, n, L) limbs."""
    n = tables.shape[0]
    v = limbs.words_to_limbs(tables.reshape(n, 8, 3, NP))
    return v.permute(1, 2, 0, 3)


def g1_window_table_plain(p: JacobianPoint, n_windows: int, src=None,
                          src_n: int = 1) -> torch.Tensor:
    pl = _plain(p.x.device)
    flat = _flat(p)
    idx = torch.arange(flat.x.shape[0], device=p.x.device)
    if src is not None:
        idx = idx // src_n * src_n + src.long()[idx % src_n]
    base = pl.jac_to_proj(JacobianPoint(*(c[idx] for c in flat)))
    bases = [base]      # 16^w B, then every window's table in one batch
    for _ in range(n_windows - 1):
        for _ in range(4):
            base = pl.proj_double(base)
        bases.append(base)
    tbl = pl.table(tuple(torch.stack(cs, dim=1) for cs in zip(*bases)))
    return pl.words(tbl).permute(2, 3, 0, 1, 4).reshape(
        idx.shape[0], n_windows, 8, PW)


def g1_fft_stage_plain(tables: torch.Tensor, digits: torch.Tensor, dst,
                       n: int, r: int) -> JacobianPoint:
    pl = _plain(tables.device)
    n_groups = tables.shape[0] // r
    per = n // r
    dev = tables.device
    g = torch.arange(n_groups, device=dev).repeat_interleave(r * r)
    kj = torch.arange(r * r, device=dev).repeat(n_groups)
    k, j = kj // r, kj % r
    q = (g % per) % digits.shape[0]
    d = digits.long()[q, k, j]                           # (terms, 2, 33)
    tbl = _table_limbs(tables.reshape(-1, 8, PW)[g * r + j])
    acc = pl.ladder_on(tbl, [(d[:, 0], False), (d[:, 1], True)])
    acc = pl.tree_sum(tuple(c.reshape(n_groups * r, r, -1) for c in acc), r)
    outs = pl.to_jac(acc)
    gk = torch.arange(n_groups * r, device=dev)
    g, k = gk // r, gk % r
    at = g // per * n + dst.long()[(g % per) * r + k]
    res = JacobianPoint(*(torch.empty_like(c) for c in outs))
    for o, c in zip(res, outs):
        o[at] = c
    return res


def g1_fixed_base_mul_plain(tables: torch.Tensor, digits) -> JacobianPoint:
    pl = _plain(tables.device)
    n = digits.shape[0]
    lanes = torch.arange(n, device=digits.device) % tables.shape[0]
    step = FIXED_WINDOWS // FIXED_PARTS
    acc = None
    for w in range(step):    # window part * step + w of each part at once
        win = torch.arange(FIXED_PARTS, device=digits.device) * step + w
        d = digits.long()[:, win]                         # (n, parts)
        idx = (d.abs() - 1).clamp(min=0)
        ent = tables[lanes[:, None], win[None], idx]       # (n, parts, 36)
        ent = limbs.words_to_limbs(ent.reshape(n, FIXED_PARTS, 3, NP))
        sx, sy, sz = ent.unbind(2)
        sy = torch.where((d < 0).unsqueeze(-1), -sy, sy)
        if acc is None:
            acc = pl.identity(sx)
        added = pl.proj_add(acc, (sx, sy, sz))
        keep = (d == 0).unsqueeze(-1)
        acc = tuple(torch.where(keep, a, b) for a, b in zip(acc, added))
    return pl.to_jac(pl.tree_sum(acc, FIXED_PARTS))


def _tree_plain(pl: _Plain, acc, first, n: int):
    """The kernel's shuffle tree over the axis -2 of (..., m, L) partials:
    lane j += lane j + s for s = m/2 .. 1, where lane j + s's first item
    first[..., j + s] lies below n."""
    s = acc[0].shape[-2] >> 1
    while s:
        head = tuple(c[..., :s, :] for c in acc)
        added = pl.proj_add(head, tuple(c[..., s:2 * s, :] for c in acc))
        valid = (first[..., s:2 * s] < n).unsqueeze(-1)
        acc = tuple(torch.where(valid, b, a) for a, b in zip(head, added))
        s >>= 1
    return tuple(c[..., 0, :] for c in acc)


def _sum_pass_plain(p: JacobianPoint, warp_rows: bool = True) -> JacobianPoint:
    """One g1_sum launch: (rows, n) points -> (rows, blocks) partials, a
    block's SUM_RUN x SUM_THREADS items each, in the kernel's order.
    warp_rows=False computes every thread of a short row too (the tests
    hold the short-row shortcut against it)."""
    pl = _plain(p.x.device)
    rows, n = p.x.shape[:2]
    span = SUM_RUN * SUM_THREADS
    nb = -(-n // span)
    x = pl.jac_to_proj(p)
    if nb * span > n:
        pad = pl.identity(x[0][:, :1].expand(rows, nb * span - n, -1))
        x = tuple(torch.cat((c, d), 1) for c, d in zip(x, pad))
    x = tuple(c.reshape(rows, nb, SUM_THREADS, SUM_RUN, -1) for c in x)
    first = torch.arange(nb * span, device=p.x.device).reshape(
        nb, SUM_THREADS, SUM_RUN)
    # a row of at most one warp's items: the threads past the first
    # power of two that holds them add nothing that reaches lane 0 (each
    # tree level adds lane j + s only where its first item lies below n),
    # so only those threads are computed, and the tree across warps,
    # whose other warps hold no item, is the identity
    warp_only = warp_rows and nb == 1 and n <= 32 * SUM_RUN
    if warp_only:
        lanes = 1 << (-(-n // SUM_RUN) - 1).bit_length()
        x = tuple(c[:, :, :lanes] for c in x)
        first = first[:, :lanes]
    acc = tuple(c[..., 0, :] for c in x)
    for k in range(1, SUM_RUN):
        added = pl.proj_add(acc, tuple(c[..., k, :] for c in x))
        valid = (first[..., k] < n).unsqueeze(-1)
        acc = tuple(torch.where(valid, b, a) for a, b in zip(acc, added))
    if warp_only:
        return pl.to_jac(_tree_plain(pl, acc, first[..., 0], n))
    first = first[..., 0].reshape(nb, SUM_THREADS // 32, 32)
    acc = _tree_plain(pl, tuple(c.reshape(rows, nb, SUM_THREADS // 32, 32, -1)
                                for c in acc), first, n)
    return pl.to_jac(_tree_plain(pl, acc, first[..., 0], n))


def _sum_axes(p: JacobianPoint, dim: int):
    """(outer, n, inner, output batch shape) of a sum over batch axis dim."""
    shape = tuple(p.x.shape[:-1])
    dim %= len(shape)
    outer, inner = math.prod(shape[:dim]), math.prod(shape[dim + 1:])
    if shape[dim] == 0:
        raise ValueError("g1_sum: no points to sum")
    return outer, shape[dim], inner, shape[:dim] + shape[dim + 1:]


def g1_sum_plain(p: JacobianPoint, dim: int = -1) -> JacobianPoint:
    outer, n, inner, shape = _sum_axes(p, dim)
    rows = JacobianPoint(*(c.reshape(outer, n, inner, NP).transpose(1, 2)
                           .reshape(outer * inner, n, NP) for c in p))
    while True:
        rows = _sum_pass_plain(rows)
        if rows.x.shape[1] == 1:
            return _shaped(rows, shape)


def g1_horner_plain(wsums: JacobianPoint) -> JacobianPoint:
    pl = _plain(wsums.x.device)
    shape = wsums.x.shape[:-2]
    w = JacobianPoint(*(c.reshape(-1, FIXED_WINDOWS, NP) for c in wsums))

    def window(j):
        return pl.jac_to_proj(JacobianPoint(*(c[:, j] for c in w)))

    acc = window(FIXED_WINDOWS - 1)
    for j in range(FIXED_WINDOWS - 2, -1, -1):
        for _ in range(4):
            acc = pl.proj_double(acc)
        acc = pl.proj_add(acc, window(j))
    return _shaped(pl.to_jac(acc), shape)


# ---- plain versions of the point kernels: Jacobian formulas, lazy ----
def _jac_double_lazy(c, x, y, z):
    """dbl-2009-l (a = 0) on redundant limbs."""
    M = functools.partial(limbs.mul_lazy, c)
    a, b = M(x, x), M(y, y)
    cc = M(b, b)
    t = x + b
    d = 2 * (M(t, t) - (a + cc))
    e = 3 * a
    x3 = M(e, e) - 2 * d
    return x3, M(e, d - x3) - 8 * cc, 2 * M(y, z)


def _words(c, v):
    return limbs.limbs_to_words(limbs.canon_wide(c, v))


def _broadcast(*ps: JacobianPoint):
    shape = torch.broadcast_shapes(*(p.x.shape for p in ps))
    return [JacobianPoint(*(t.expand(shape) for t in p)) for p in ps]


def g1_double_plain(p: JacobianPoint) -> JacobianPoint:
    c = limbs.consts(fp.SPEC, p.x.device)
    out = _jac_double_lazy(c, *(limbs.words_to_limbs(t) for t in p))
    return JacobianPoint(*(_words(c, v) for v in out))


def g1_add_plain(p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """add-2007-bl, then point_add_tile's selects in its order: the double
    where P == Q, all-zero words where P == -Q, P where Q is at infinity,
    Q where P is."""
    p, q = _broadcast(p, q)
    c = limbs.consts(fp.SPEC, p.x.device)
    M = functools.partial(limbs.mul_lazy, c)
    x1, y1, z1 = (limbs.words_to_limbs(t) for t in p)
    x2, y2, z2 = (limbs.words_to_limbs(t) for t in q)
    z1z1, z2z2 = M(z1, z1), M(z2, z2)
    u1, u2 = M(x1, z2z2), M(x2, z1z1)
    s1, s2 = M(M(y1, z2), z2z2), M(M(y2, z1), z1z1)
    h, rr = u2 - u1, s2 - s1
    i = M(2 * h, 2 * h)
    j, v, rr2 = M(h, i), M(u1, i), 2 * rr
    x3 = M(rr2, rr2) - (j + 2 * v)
    y3 = M(rr2, v - x3) - 2 * M(s1, j)
    z3 = M(M(z1 + z2, z1 + z2) - (z1z1 + z2z2), h)
    res = JacobianPoint(*(_words(c, t) for t in (x3, y3, z3)))

    same_x = limbs.is_zero(limbs.canon_wide(c, h))
    same_y = limbs.is_zero(limbs.canon_wide(c, rr))
    p_inf, q_inf = fp.is_zero(p.z), fp.is_zero(q.z)
    both = ~p_inf & ~q_inf
    zero = torch.zeros_like(res.x)
    dbl = same_x & same_y & both
    selects = [(same_x & ~same_y & both, JacobianPoint(zero, zero, zero)),
               (q_inf, p), (p_inf, q)]
    if bool(dbl.any()):     # the double, only if some lane takes it
        selects.insert(0, (dbl, g1_double_plain(p)))
    for mask, other in selects:
        res = JacobianPoint(*(fp.select(mask, a, b)
                              for a, b in zip(other, res)))
    return res


# ---- kernel wrappers ----
def _check_points(what: str, n: int, *ps: JacobianPoint) -> None:
    for p in ps:
        for c in p:
            check_words(c, NP, what)
            if c.numel() != n * NP:
                raise ValueError(f"{what}: point batch sizes differ")


def _check_digits(what: str, d: torch.Tensor, n: int, device) -> None:
    if d.device != device or d.dtype != torch.int32:
        raise ValueError(f"{what}: digits must be int32 on {device}")
    if d.numel() != n * d.shape[-1] or not d.is_contiguous():
        raise ValueError(f"{what}: digits must be contiguous (n, windows)")
    if d.shape[-1] > 64:
        raise ValueError(f"{what}: at most 64 windows")


def g1_scalar_mul(p: JacobianPoint, digits) -> JacobianPoint:
    """K3: per lane p * sum_j digits[..., j] 16^j for signed digits in
    [-8, 8], LSB-first (fr.scalar_windows_signed), Jacobian in and out
    (replaces kzg_tpu/curve/pallas_g1.py::_scalar_mul_fn)."""
    if p.x.device.type == "cpu":
        return g1_scalar_mul_plain(p, digits)
    n = p.x.numel() // NP
    _check_points("g1_scalar_mul", n, p)
    _check_digits("g1_scalar_mul", digits, n, p.x.device)
    out = JacobianPoint(*(torch.empty_like(c) for c in p))
    if n:
        lib = build.library("g1_kernels")
        LAUNCHES["g1_scalar_mul"] += 1
        build.check(lib.kzg_g1_scalar_mul(
            *(c.data_ptr() for c in out), *(c.data_ptr() for c in p),
            digits.data_ptr(), digits.shape[-1], n, stream_of(p.x)),
            "g1_scalar_mul")
    return out


def g1_glv_butterfly(a: JacobianPoint, b: JacobianPoint, d1, d2):
    """K4: per lane t = k1 B + k2 phi(B) from GLV digit rows d1, d2
    (..., 33), then (lo, hi) = (A + t, A - t). B must lie in the
    r-torsion subgroup (replaces
    kzg_tpu/curve/pallas_g1.py::_scalar_mul_glv_fn)."""
    if a.x.device.type == "cpu":
        return g1_glv_butterfly_plain(a, b, d1, d2)
    n = a.x.numel() // NP
    _check_points("g1_glv_butterfly", n, a, b)
    for d in (d1, d2):
        _check_digits("g1_glv_butterfly", d, n, a.x.device)
    if d1.shape != d2.shape:
        raise ValueError("g1_glv_butterfly: digit rows differ in shape")
    lo = JacobianPoint(*(torch.empty_like(c) for c in a))
    hi = JacobianPoint(*(torch.empty_like(c) for c in a))
    if n:
        lib = build.library("g1_kernels")
        LAUNCHES["g1_glv_butterfly"] += 1
        build.check(lib.kzg_g1_glv_butterfly(
            *(c.data_ptr() for c in lo), *(c.data_ptr() for c in hi),
            *(c.data_ptr() for c in a), *(c.data_ptr() for c in b),
            d1.data_ptr(), d2.data_ptr(), d1.shape[-1], n, stream_of(a.x)),
            "g1_glv_butterfly")
    return lo, hi


def g1_window_table(p: JacobianPoint, n_windows: int, src=None,
                    src_n: int = 1) -> torch.Tensor:
    """Window tables, (n, n_windows, 8, 36) int32: entry m of window w of
    point i is (m+1) 16^w P as projective words, P = p[(i // src_n) src_n
    + src[i % src_n]] (P = p[i] without src). n_windows = 1 gives the
    [1..8]P tables of a G1 FFT stage, 64 the fixed-base tables of the FK20
    settings."""
    if p.x.device.type == "cpu":
        return g1_window_table_plain(p, n_windows, src, src_n)
    n = p.x.numel() // NP
    _check_points("g1_window_table", n, p)
    if src is not None:
        if src.device != p.x.device or src.dtype != torch.int32 \
                or src.numel() != src_n or n % src_n:
            raise ValueError("g1_window_table: src must be int32 (src_n,) "
                             "on the points' device, src_n dividing n")
    out = torch.empty((n, n_windows, 8, PW), dtype=torch.int32,
                      device=p.x.device)
    if n:
        lib = build.library("g1_table_kernels")
        LAUNCHES["g1_window_table"] += 1
        build.check(lib.kzg_g1_window_table(
            out.data_ptr(), *(c.data_ptr() for c in p),
            None if src is None else src.data_ptr(), src_n, n_windows, n,
            stream_of(p.x)), "g1_window_table")
    return out


def stage_smem_bytes(r: int) -> int:
    """Dynamic shared memory of a radix-r g1_fft_stage block: its staged
    tables (r, or 128/r for the blocks that hold several groups), or its
    128 partial points where they are more."""
    tables = max(r, STAGE_THREADS // r) * TABLE_SMEM_WORDS
    return 4 * max(tables, STAGE_THREADS * PW)


def g1_fft_stage(tables: torch.Tensor, digits: torch.Tensor, dst, n: int,
                 r: int) -> JacobianPoint:
    """One radix-r G1 FFT stage over groups of r inputs:
        out[t n + dst[gl r + k]] = sum_j s[gl % S, k, j] in[g r + j]
    for group g = t (n/r) + gl of transform t, from the inputs' [1..8]
    tables (g1_window_table, (groups r, 1, 8, 36)) and int8 GLV digit
    rows (S, r, r, 2, 33) of the scalars s (curve/glv.py); dst int32
    (n,). Inputs must lie in the r-torsion subgroup (replaces, for the G1
    FFT, the route of kzg_tpu/curve/pallas_g1.py::_scalar_mul_glv_fn)."""
    if tables.device.type == "cpu":
        return g1_fft_stage_plain(tables, digits, dst, n, r)
    check_words(tables, PW, "g1_fft_stage")
    log_r = r.bit_length() - 1
    if r < 2 or r & (r - 1) or r > STAGE_THREADS or n % r:
        raise ValueError("g1_fft_stage: r must be a power of two in "
                         f"[2, {STAGE_THREADS}] dividing n")
    n_pts = tables.numel() // (8 * PW)
    if n_pts % n:
        raise ValueError("g1_fft_stage: tables are not whole transforms")
    if digits.dtype != torch.int8 or digits.device != tables.device or \
            tuple(digits.shape[1:]) != (r, r, 2, 33) or \
            not digits.is_contiguous():
        raise ValueError("g1_fft_stage: digits must be contiguous int8 "
                         f"(S, {r}, {r}, 2, 33) on the tables' device")
    if dst.dtype != torch.int32 or dst.device != tables.device or \
            dst.numel() != n:
        raise ValueError("g1_fft_stage: dst must be int32 (n,)")
    out = JacobianPoint(*(torch.empty((n_pts, NP), dtype=torch.int32,
                                      device=tables.device)
                          for _ in range(3)))
    if n_pts:
        lib = build.library("g1_fft_kernels")
        LAUNCHES["g1_fft_stage"] += 1
        build.check(lib.kzg_g1_fft_stage(
            *(c.data_ptr() for c in out), tables.data_ptr(),
            digits.data_ptr(), dst.data_ptr(), n, log_r, digits.shape[0],
            n_pts // r, stage_smem_bytes(r), stream_of(tables)),
            "g1_fft_stage")
    return out


def g1_fixed_base_mul(tables: torch.Tensor, digits) -> JacobianPoint:
    """Per lane sum_w sign(d_w) T[b][w][|d_w| - 1] over the 64 signed
    digits of fr.scalar_windows_signed, b = lane % m for m tables: the
    lane's base times the scalar, from its fixed-base table
    (g1_window_table with 64 windows), Jacobian out (replaces, on the FK20
    path and the commitment, the route of
    kzg_tpu/curve/pallas_g1.py::_scalar_mul_fn)."""
    if tables.device.type == "cpu":
        return g1_fixed_base_mul_plain(tables, digits)
    check_words(tables, PW, "g1_fixed_base_mul")
    n = digits.shape[0]
    m = tables.shape[0]
    if tuple(tables.shape[1:]) != (FIXED_WINDOWS, 8, PW) or m == 0 or n % m:
        raise ValueError("g1_fixed_base_mul: tables must be (m, 64, 8, 36) "
                         "with m dividing the lanes")
    _check_digits("g1_fixed_base_mul", digits, n, tables.device)
    if digits.shape[-1] != FIXED_WINDOWS:
        raise ValueError("g1_fixed_base_mul: 64 windows a lane")
    out = JacobianPoint(*(torch.empty((n, NP), dtype=torch.int32,
                                      device=tables.device)
                          for _ in range(3)))
    if n:
        lib = build.library("g1_table_kernels")
        LAUNCHES["g1_fixed_base_mul"] += 1
        build.check(lib.kzg_g1_fixed_base_mul(
            *(c.data_ptr() for c in out), tables.data_ptr(),
            digits.data_ptr(), n, m, stream_of(tables)), "g1_fixed_base_mul")
    return out


def g1_sum(p: JacobianPoint, dim: int = -1) -> JacobianPoint:
    """The sum of the points along batch axis `dim`: (R, N) -> (R,) for
    dim = -1, one launch when N <= SUM_RUN x SUM_THREADS, and one more for
    the block partials of a wider row (replaces, in the port's tree sums,
    the route of kzg_tpu/curve/pallas_g1.py::_add_fn). Infinity enters as
    any Z == 0 and leaves as all-zero words."""
    if p.x.device.type == "cpu":
        return g1_sum_plain(p, dim)
    outer, n, inner, shape = _sum_axes(p, dim)
    rows = outer * inner
    _check_points("g1_sum", rows * n, p)
    span = SUM_RUN * SUM_THREADS
    while True:
        nb = -(-n // span)
        out = JacobianPoint(*(torch.empty((rows * nb, NP), dtype=torch.int32,
                                          device=p.x.device)
                              for _ in range(3)))
        if rows:
            lib = build.library("g1_sum_kernels")
            LAUNCHES["g1_sum"] += 1
            build.check(lib.kzg_g1_sum(
                *(c.data_ptr() for c in out), *(c.data_ptr() for c in p),
                rows, n, inner, nb, stream_of(p.x)), "g1_sum")
        if nb == 1:
            return _shaped(out, shape)
        p, n, inner = out, nb, 1


def g1_horner(wsums: JacobianPoint) -> JacobianPoint:
    """acc = sum_j 16^j S_j over (..., 64) LSB-first window sums ->
    (...,): 63 x (4 doublings + 1 add) in one thread an MSM (replaces, in
    the variable-base MSM, the route of kzg_tpu/curve/pallas_g1.py::
    _double_fn and ::_add_fn)."""
    if wsums.x.device.type == "cpu":
        return g1_horner_plain(wsums)
    shape = wsums.x.shape[:-2]
    if wsums.x.shape[-2] != FIXED_WINDOWS:
        raise ValueError("g1_horner: 64 window sums an MSM")
    b = wsums.x.numel() // (FIXED_WINDOWS * NP)
    _check_points("g1_horner", b * FIXED_WINDOWS, wsums)
    out = JacobianPoint(*(torch.empty((b, NP), dtype=torch.int32,
                                      device=wsums.x.device)
                          for _ in range(3)))
    if b:
        lib = build.library("g1_sum_kernels")
        LAUNCHES["g1_horner"] += 1
        build.check(lib.kzg_g1_horner(
            *(c.data_ptr() for c in out), *(c.data_ptr() for c in wsums), b,
            stream_of(wsums.x)), "g1_horner")
    return _shaped(out, shape)


def g1_add(p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    """Complete Jacobian add per lane, batch shapes broadcast (replaces
    kzg_tpu/curve/pallas_g1.py::_add_fn). P == -Q gives all-zero words."""
    if p.x.device.type == "cpu":
        return g1_add_plain(p, q)
    p, q = (JacobianPoint(*(t.contiguous() for t in pt))
            for pt in _broadcast(p, q))
    n = p.x.numel() // NP
    _check_points("g1_add", n, p, q)
    out = JacobianPoint(*(torch.empty_like(c) for c in p))
    if n:
        lib = build.library("g1_point_kernels")
        LAUNCHES["g1_add"] += 1
        build.check(lib.kzg_g1_add(
            *(c.data_ptr() for c in out), *(c.data_ptr() for c in p),
            *(c.data_ptr() for c in q), n, stream_of(p.x)), "g1_add")
    return out


def g1_double(p: JacobianPoint) -> JacobianPoint:
    """Jacobian double per lane, dbl-2009-l (replaces
    kzg_tpu/curve/pallas_g1.py::_double_fn). Infinity stays at Z = 0."""
    if p.x.device.type == "cpu":
        return g1_double_plain(p)
    p = JacobianPoint(*(t.contiguous() for t in p))
    n = p.x.numel() // NP
    _check_points("g1_double", n, p)
    out = JacobianPoint(*(torch.empty_like(c) for c in p))
    if n:
        lib = build.library("g1_point_kernels")
        LAUNCHES["g1_double"] += 1
        build.check(lib.kzg_g1_double(
            *(c.data_ptr() for c in out), *(c.data_ptr() for c in p), n,
            stream_of(p.x)), "g1_double")
    return out
