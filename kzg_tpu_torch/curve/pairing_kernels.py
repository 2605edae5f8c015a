"""The pairing kernels (csrc/pairing_kernels.cu on csrc/tower.cuh) with
their plain PyTorch versions: K-a `g2_scalar_mul`, K-b in two parts
(`pairing_lines`, the G2 half of the Miller loop, and `pairing_miller_eval`,
its evaluation at the G1 points; `pairing_miller` runs both) and K-c
`pairing_final_exp`.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Each launch adds one to
the wrapper's entry in `LAUNCHES`. The plain versions run the kernels'
algorithms on the redundant int64 engine (curve/tower.py) and reduce at
the end; both end on canonical words of the same field elements, so they
agree word for word.

K-a replaces `g2.ops.scalar_mul` of kzg_tpu/kzg/settings.py:60-66 (plain
jnp in the JAX package: a 4-bit window ladder on the masked Jacobian
formulas): per lane [k]Q on E'(Fp2) from the 64 signed digits of
fr.scalar_windows_signed, K3's ladder (csrc/g1.cuh) over Fp2 with the
complete projective formulas for a = 0, b3 = 3 b' = 12 (1 + u). No path
runs it since the batched check took its bilinear form.

K-b replaces the Miller loops of kzg_tpu/curve/pairing_device.py:97-205
(plain jnp): per lane f = f_{|x|,Qa}(Pa) f_{|x|,Qb}(Pb), conjugated for
the negative x, sharing the squarings of f. It runs on the twist: the
lines part walks T over Jacobian Fp2 coordinates and emits the tangent
and chord lines, scaled by factors in Fp2, as (l0, l1, l4); it depends
on Q alone, so the batched check computes the lines of its fixed G2
points once. The evaluation multiplies f by l0 Z^3 + (l1 X Z) v + (l4 Y)
v w for P = (X, Y, Z): the line at the affine P times Z^3, an Fp factor.
The final exponentiation kills both factors, so f differs from the
reference's Miller value; only after it do the two agree.

K-c replaces the final exponentiation of
kzg_tpu/curve/pairing_device.py:252-312 (plain jnp): the easy part
conj(f) f^-1, then ^(p^2 + 1), and the reference's hard exponent
d = (p^4 - p^2 + 1)/r as the x-chain d = c (x - 1)(x + p)(x^2 + p^2 - 1)
+ 1 with c = (x - 1)/3 (exact, since x = 1 mod 3): powers by |x| and |c|
on cyclotomic squarings, Frobenius maps and conjugations; the gammas of
the Frobenius maps are computed here on the host and passed in.

K-b's evaluation and K-c run a lane on a warp, its Fp12 products spread
over the 32 threads (a warp was faster than 8 or 16 threads a lane at the
verification path's 128 lanes, PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import build
from ..field import fp
from ..field.constants import BLS_X, FP_MODULUS
from ..field.kernels import check_words, stream_of
from . import tower as T
from .weierstrass import JacobianPoint

LAUNCHES = {"g2_scalar_mul": 0, "pairing_lines": 0,
            "pairing_miller_eval": 0, "pairing_final_exp": 0}

NP = fp.N_WORDS
F12_WORDS = 2 * 3 * 2 * NP      # 144 words an Fp12 element
MILLER_BITS = bin(-BLS_X)[3:]   # |x| below its leading bit, MSB first
N_LINES = len(MILLER_BITS) + MILLER_BITS.count("1")   # 68 lines a point
# the hard part's c = (x - 1)/3 < 0 by its absolute value: x = 1 mod 3 and
# (p^4 - p^2 + 1)/r = c (x - 1)(x + p)(x^2 + p^2 - 1) + 1
HARD_C = (-BLS_X + 1) // 3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def frobenius_gamma_ints(k: int) -> tuple:
    """The 6 gammas of x -> x^(p^k) on Fp12, as (c0, c1) ints, slot
    (j, i) = coefficient of w^j v^i: (w^e)^(p^k) = w^e xi^(e (p^k-1)/6)
    for e = j + 2 i (w^6 = xi), so the gamma of slot e is
    xi^(e (p^k - 1) / 6), an Fp2 element (kzg_tpu/curve/pairing_device.py
    :217-240 reads the same values off basis^(p^k) in its exact tower)."""
    from .pairing import F2

    out = []
    for j in range(2):
        for i in range(3):
            g, base, e = F2.ONE, F2(1, 1), (j + 2 * i) * (FP_MODULUS ** k - 1) // 6
            while e:
                if e & 1:
                    g = g * base
                base = base * base
                e >>= 1
            out.append((g.a, g.b))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def frobenius_gammas(device) -> torch.Tensor:
    """Montgomery words (3, 2, 3, 2, 12): the gammas of p^1, p^2, p^3."""
    vals = [list(frobenius_gamma_ints(k)) for k in (1, 2, 3)]
    return fp.from_int(np.asarray(vals, dtype=object).reshape(3, 2, 3, 2),
                       device).contiguous()


# ---- plain versions ----
def _b3(v):
    """3 b' v = 12 (1 + u) v for E': y^2 = x^3 + 4 (1 + u)."""
    return 12 * T.f2_mul_xi(v)


def _renorm_all(*vs):
    return T.renorm(torch.stack(torch.broadcast_tensors(*vs))).unbind(0)


def _g2_proj_add(p, q):
    """RCB15 Algorithm 7 (a = 0) on E'(Fp2), in K-a's operation."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2, s3, s4, s5 = T.f2_mul_raw(
        torch.stack((x1, y1, z1, x1 + y1, y1 + z1, x1 + z1)),
        torch.stack((x2, y2, z2, x2 + y2, y2 + z2, x2 + z2))).unbind(0)
    t3 = s3 - (t0 + t1)
    t4 = s4 - (t1 + t2)
    y3 = s5 - (t0 + t2)
    t0 = 3 * t0
    t2 = _b3(t2)
    z3 = t1 + t2
    t1 = t1 - t2
    y3 = _b3(y3)
    t3, t4, t1, y3, z3, t0 = _renorm_all(t3, t4, t1, y3, z3, t0)
    u = T.f2_mul_raw(torch.stack((t3, t4, t1, y3, z3, t0)),
                     torch.stack((t1, y3, z3, t0, t4, t3))).unbind(0)
    return _renorm_all(u[0] - u[1], u[2] + u[3], u[4] + u[5])


def _g2_proj_double(p):
    """RCB15 Algorithm 9 (a = 0) on E'(Fp2)."""
    x, y, z = p
    t0, t1, t2, xy = T.f2_mul_raw(torch.stack((y, y, z, x)),
                                  torch.stack((y, z, z, y))).unbind(0)
    z3 = 8 * t0
    t2 = _b3(t2)
    y3 = t0 + t2
    t0 = t0 - 3 * t2
    t2, z3, t1, t0, y3, xy = _renorm_all(t2, z3, t1, t0, y3, xy)
    u = T.f2_mul_raw(torch.stack((t2, t1, t0, t0)),
                     torch.stack((z3, z3, y3, xy))).unbind(0)
    return _renorm_all(2 * u[3], u[0] + u[2], u[1])


def g2_scalar_mul_plain(p: JacobianPoint, digits) -> JacobianPoint:
    shape = p.x.shape[:-2]
    n = p.x.numel() // (2 * NP)
    x, y, z = (T.from_words(c.reshape(n, 2, NP)) for c in p)
    dev = x.device
    one2 = T.f2(T._one(dev), torch.zeros_like(T._one(dev)))
    inf = (p.z.reshape(n, -1) == 0).all(-1)[:, None, None]
    # Jacobian -> projective (XZ : Y : Z^3); Z = 0 -> (0 : 1 : 0)
    xz, zz = T.f2_mul_raw(torch.stack((x, z)), torch.stack((z, z))).unbind(0)
    base = (T.renorm(xz), torch.where(inf, one2, y),
            T.f2_mul(T.renorm(zz), z))
    tbl = [base]
    for _ in range(7):
        tbl.append(_g2_proj_add(tbl[-1], base))
    tbl = torch.stack([torch.stack(t) for t in tbl])     # (8, 3, n, 2, L)
    zero2 = torch.zeros_like(one2)
    acc = (zero2.expand(n, 2, T.L), one2.expand(n, 2, T.L),
           zero2.expand(n, 2, T.L))
    dig = digits.reshape(n, -1).long()
    lanes = torch.arange(n, device=dev)
    for w in range(dig.shape[-1] - 1, -1, -1):
        for _ in range(4):
            acc = _g2_proj_double(acc)
        d = dig[:, w]
        if not bool((d != 0).any()):
            continue
        sx, sy, sz = tbl[(d.abs() - 1).clamp(min=0), :, lanes].unbind(1)
        sy = torch.where((d < 0)[:, None, None], -sy, sy)
        added = _g2_proj_add(acc, (sx, sy, sz))
        keep = (d == 0)[:, None, None]
        acc = tuple(torch.where(keep, a, b) for a, b in zip(acc, added))
    ax, ay, az = acc
    ox, ozz = T.f2_mul_raw(torch.stack((ax, az)),
                           torch.stack((az, az))).unbind(0)
    oy = T.f2_mul(ay, T.renorm(ozz))
    return JacobianPoint(*(T.to_words(v).reshape(shape + (2, NP))
                           for v in (ox, oy, az)))


def _dbl_step(t):
    """Doubling of T (Jacobian, dbl-2009-l) and its tangent line, scaled
    by 2 Y Z^3: l0 = 3X^3 - 2Y^2, l1 = -3X^2 Z^2, l4 = 2 Y Z^3 (Z3 Z^2),
    the line being l0 + (l1 xP) v + (l4 yP) v w."""
    X, Y, Z = t
    A, B, Z2, YZ = T.f2_mul_raw(torch.stack((X, Y, Z, Y)),
                                torch.stack((X, Y, Z, Z))).unbind(0)
    A, B, Z2, YZ = _renorm_all(A, B, Z2, YZ)
    E = 3 * A
    XB = X + B
    Z3 = 2 * YZ
    C, XB2, F, EX, EZ2, Z3Z2 = T.f2_mul_raw(
        torch.stack((B, XB, E, E, E, Z3)),
        torch.stack((B, XB, E, X, Z2, Z2))).unbind(0)
    D = 2 * (XB2 - A - C)
    X3 = F - 2 * D
    D, X3, C = _renorm_all(D, X3, C)
    Y3 = T.f2_mul_raw(E, D - X3) - 8 * C
    new = _renorm_all(X3, Y3, Z3)
    return new, _renorm_all(EX - 2 * B, -EZ2, Z3Z2)


def _add_step(t, xq, yq):
    """T + Q for affine Q (madd-2007-bl) and the chord line, scaled by
    2 Z1 H: l0 = r xq - yq Z3, l1 = -r, l4 = Z3 (r = 2 (S2 - Y1),
    Z3 = 2 Z1 H)."""
    X1, Y1, Z1 = t
    Z1Z1 = T.f2_mul(Z1, Z1)
    U2, Z1c = T.f2_mul_raw(torch.stack((xq, Z1)),
                           torch.stack((Z1Z1, Z1Z1))).unbind(0)
    U2, Z1c = _renorm_all(U2, Z1c)
    H = U2 - X1
    ZH = Z1 + H
    S2, HH, ZH2 = T.f2_mul_raw(torch.stack((yq, H, ZH)),
                               torch.stack((Z1c, H, ZH))).unbind(0)
    S2, HH, ZH2 = _renorm_all(S2, HH, ZH2)
    I = 4 * HH
    r = 2 * (S2 - Y1)
    Z3 = ZH2 - Z1Z1 - HH
    I, r, Z3 = _renorm_all(I, r, Z3)
    J, V, R2, RX, YZ3 = T.f2_mul_raw(
        torch.stack((H, X1, r, r, yq)),
        torch.stack((I, I, r, xq, Z3))).unbind(0)
    J, V, R2, RX, YZ3 = _renorm_all(J, V, R2, RX, YZ3)
    X3 = T.renorm(R2 - J - 2 * V)
    RV, YJ = T.f2_mul_raw(torch.stack((r, Y1)),
                          torch.stack((V - X3, J))).unbind(0)
    Y3 = RV - 2 * YJ
    return _renorm_all(X3, Y3, Z3), (RX - YZ3, -r, Z3)


def pairing_lines_plain(qx, qy) -> torch.Tensor:
    """The lines of affine G2 points (n, 2, 12) words:
    (n, N_LINES, 3, 2, 12) words, (l0, l1, l4) of each doubling and
    addition in the loop's order."""
    xq, yq = T.from_words(qx), T.from_words(qy)
    one2 = T.f2(T._one(xq.device), torch.zeros_like(T._one(xq.device)))
    t = (xq, yq, one2.expand(xq.shape))
    lines = []
    for bit in MILLER_BITS:
        t, l = _dbl_step(t)
        lines.append(torch.stack(l, -3))
        if bit == "1":
            t, l = _add_step(t, xq, yq)
            lines.append(torch.stack(l, -3))
    return T.to_words(torch.stack(lines, -4)).contiguous()


def pairing_miller_eval_plain(a1: JacobianPoint, a_lines, a2inf,
                              b1: JacobianPoint, b_lines, b2inf):
    n = a1.x.shape[0]
    dev = a1.x.device
    one12 = T.f12_one((n,), dev)
    zero2 = torch.zeros_like(one12[:, 0, 0])
    skip, evals = [], []
    for p, lines, inf in ((a1, a_lines, a2inf), (b1, b_lines, b2inf)):
        skip.append((fp.is_zero(p.z) | inf.bool())[:, None, None, None, None])
        x, y, z = (T.from_words(c) for c in p)
        z3, xz = T.mul(torch.stack((T.mul(z, z), x)),
                       torch.stack((z, z))).unbind(0)
        # every line at P, scaled by Z^3: (l0 Z^3, l1 X Z, l4 Y)
        e = torch.stack((z3, xz, y), -2)[:, None, :, None, :]
        evals.append(T.mul(T.from_words(lines), e).unbind(-3))
    f = one12
    idx = 0
    for bit in MILLER_BITS:
        f = T.f12_sqr(f)
        for _ in range(1 + (bit == "1")):
            for k in range(2):
                l0, l1, l4 = (v[:, idx] for v in evals[k])
                line = T.f12(T.f6(l0, l1, zero2), T.f6(zero2, l4, zero2))
                f = T.f12_mul(f, torch.where(skip[k], one12, line))
            idx += 1
    return T.to_words(T.f12_conj(f)).contiguous()


def pairing_miller_plain(a1: JacobianPoint, a2x, a2y, a2inf,
                         b1: JacobianPoint, b2x, b2y, b2inf):
    lines = pairing_lines_plain(torch.cat((a2x, b2x)), torch.cat((a2y, b2y)))
    n = a1.x.shape[0]
    return pairing_miller_eval_plain(a1, lines[:n], a2inf, b1, lines[n:],
                                     b2inf)


def _cyc_pow(m, e: int):
    """m^e for m in the cyclotomic subgroup, e > 0 static."""
    acc = m
    for bit in bin(e)[3:]:
        acc = T.f12_cyclotomic_sqr(acc)
        if bit == "1":
            acc = T.f12_mul(acc, m)
    return acc


def pairing_final_exp_plain(f):
    dev = f.device
    g = T.from_words(frobenius_gammas(dev))
    a = T.from_words(f)
    t = T.f12_mul(T.f12_conj(a), T.f12_inv(a))         # f^(p^6 - 1)
    m = T.f12_mul(T.frobenius(t, g[1], False), t)       # ^(p^2 + 1)
    x = -BLS_X
    a = T.f12_conj(_cyc_pow(m, HARD_C))                 # m^c
    b = T.f12_mul(T.f12_conj(_cyc_pow(a, x)), T.f12_conj(a))  # a^(x - 1)
    e = T.f12_mul(T.f12_conj(_cyc_pow(b, x)),
                  T.frobenius(b, g[0], True))           # b^(x + p)
    r = T.f12_mul(_cyc_pow(_cyc_pow(e, x), x), T.frobenius(e, g[1], False))
    r = T.f12_mul(T.f12_mul(r, T.f12_conj(e)), m)      # e^(x^2+p^2-1) m
    out = T.to_words(r).contiguous()
    return out, T.f12_is_one(out)


# ---- kernel wrappers ----
def _check_f(what: str, t: torch.Tensor, n: int, shape) -> None:
    check_words(t, NP, what)
    if tuple(t.shape) != (n,) + tuple(shape) + (NP,):
        raise ValueError(f"{what}: expected ({n}, {shape}, {NP}) words, "
                         f"got {tuple(t.shape)}")


def g2_scalar_mul(p: JacobianPoint, digits) -> JacobianPoint:
    """K-a: per lane q * sum_j digits[..., j] 16^j on E'(Fp2), signed
    digits in [-8, 8] LSB first (fr.scalar_windows_signed), Jacobian Fp2
    coordinates (..., 2, 12) in and out; infinity enters as Z == 0 and
    leaves as all-zero words (replaces g2.ops.scalar_mul of
    kzg_tpu/kzg/settings.py:60-66)."""
    if p.x.device.type == "cpu":
        return g2_scalar_mul_plain(p, digits)
    p = JacobianPoint(*(c.contiguous() for c in p))
    n = p.x.numel() // (2 * NP)
    for c in p:
        check_words(c, NP, "g2_scalar_mul")
        if c.numel() != n * 2 * NP or c.shape[-2] != 2:
            raise ValueError("g2_scalar_mul: coordinates must be (..., 2, 12)")
    if digits.dtype != torch.int32 or digits.device != p.x.device or \
            digits.numel() != n * digits.shape[-1] or \
            not digits.is_contiguous() or digits.shape[-1] > 64:
        raise ValueError("g2_scalar_mul: digits must be contiguous int32 "
                         "(n, <= 64) on the points' device")
    out = JacobianPoint(*(torch.empty_like(c) for c in p))
    if n:
        lib = build.library("pairing_kernels")
        LAUNCHES["g2_scalar_mul"] += 1
        build.check(lib.kzg_g2_scalar_mul(
            *(c.data_ptr() for c in out), *(c.data_ptr() for c in p),
            digits.data_ptr(), digits.shape[-1], n, stream_of(p.x)),
            "g2_scalar_mul")
    return out


def pairing_lines(qx, qy) -> torch.Tensor:
    """K-b's lines part: affine G2 points (n, 2, 12) words (a point at
    infinity gives lines of no use; the evaluation skips it) ->
    (n, N_LINES, 3, 2, 12) words, one thread a point."""
    if qx.device.type == "cpu":
        return pairing_lines_plain(qx, qy)
    n = qx.shape[0]
    qx, qy = qx.contiguous(), qy.contiguous()
    for c in (qx, qy):
        _check_f("pairing_lines", c, n, (2,))
    out = torch.empty((n, N_LINES, 3, 2, NP), dtype=torch.int32,
                      device=qx.device)
    if n:
        lib = build.library("pairing_kernels")
        LAUNCHES["pairing_lines"] += 1
        build.check(lib.kzg_pairing_lines(out.data_ptr(), qx.data_ptr(),
                                          qy.data_ptr(), n, stream_of(out)),
                    "pairing_lines")
    return out


def pairing_miller_eval(a1: JacobianPoint, a_lines, a2inf,
                        b1: JacobianPoint, b_lines, b2inf) -> torch.Tensor:
    """K-b's evaluation: per lane the two-pair Miller value, conjugated
    (x < 0), as Montgomery words (n, 2, 3, 2, 12), of G1 points (n, 12)
    Jacobian and the lines of their G2 points ((n or 1, N_LINES, 3, 2, 12)
    words: one set a lane, or one set for all lanes), with bool infinity
    flags (n,) for the G2 points. A pair with a point at infinity
    contributes 1 (kzg_tpu/curve/pairing_device.py:341-357)."""
    if a1.x.device.type == "cpu":
        return pairing_miller_eval_plain(a1, a_lines, a2inf, b1, b_lines,
                                         b2inf)
    n = a1.x.shape[0]
    pts = [c.contiguous() for c in (*a1, *b1)]
    for c in pts:
        _check_f("pairing_miller_eval", c, n, ())
    lines = [t.contiguous() for t in (a_lines, b_lines)]
    for t in lines:
        _check_f("pairing_miller_eval", t, t.shape[0], (N_LINES, 3, 2))
        if t.shape[0] not in (1, n) or t.device != a1.x.device:
            raise ValueError("pairing_miller_eval: lines must be (n or 1, "
                             f"{N_LINES}, 3, 2, 12) on the points' device")
    flags = [f.to(torch.int32).contiguous() for f in (a2inf, b2inf)]
    for f in flags:
        if f.shape != (n,) or f.device != a1.x.device:
            raise ValueError("pairing_miller_eval: infinity flags must be "
                             "(n,)")
    bcast = sum(1 << k for k, t in enumerate(lines) if t.shape[0] == 1)
    out = torch.empty((n, 2, 3, 2, NP), dtype=torch.int32,
                      device=a1.x.device)
    if n:
        lib = build.library("pairing_kernels")
        LAUNCHES["pairing_miller_eval"] += 1
        build.check(lib.kzg_pairing_miller_eval(
            out.data_ptr(), *(c.data_ptr() for c in pts[:3]),
            lines[0].data_ptr(), flags[0].data_ptr(),
            *(c.data_ptr() for c in pts[3:]), lines[1].data_ptr(),
            flags[1].data_ptr(), bcast, n, stream_of(out)),
            "pairing_miller_eval")
    return out


def pairing_miller(a1: JacobianPoint, a2x, a2y, a2inf, b1: JacobianPoint,
                   b2x, b2y, b2inf) -> torch.Tensor:
    """K-b on a lane's own G2 points: the lines of all 2n affine G2 points
    (n, 2, 12) in one launch, then the evaluation at the G1 points (n, 12)
    Jacobian; bool infinity flags (n,) for the G2 points. Replaces the
    Miller loops of kzg_tpu/curve/pairing_device.py:97-205."""
    n = a1.x.shape[0]
    lines = pairing_lines(torch.cat((a2x, b2x)), torch.cat((a2y, b2y)))
    return pairing_miller_eval(a1, lines[:n], a2inf, b1, lines[n:], b2inf)


def pairing_final_exp(f: torch.Tensor):
    """K-c: f^((p^12 - 1)/r) per lane for Montgomery words
    (n, 2, 3, 2, 12) -> (the same shape, bool is_one (n,)). Replaces the
    final exponentiation of kzg_tpu/curve/pairing_device.py:252-312."""
    if f.device.type == "cpu":
        return pairing_final_exp_plain(f)
    f = f.contiguous()
    n = f.shape[0]
    _check_f("pairing_final_exp", f, n, (2, 3, 2))
    out = torch.empty_like(f)
    ok = torch.empty((n,), dtype=torch.int32, device=f.device)
    if n:
        lib = build.library("pairing_kernels")
        gam = frobenius_gammas(f.device)
        LAUNCHES["pairing_final_exp"] += 1
        build.check(lib.kzg_pairing_final_exp(
            out.data_ptr(), ok.data_ptr(), f.data_ptr(), gam.data_ptr(), n,
            stream_of(f)), "pairing_final_exp")
    return out, ok.bool()
