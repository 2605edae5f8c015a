"""Plain Fp2/Fp6/Fp12 tower arithmetic on the redundant int64 engine: the
arithmetic of the pairing kernels' plain versions
(curve/pairing_kernels.py), and with them the CPU path of the device
pairing (kzg_tpu/curve/tower.py).

The layouts extend fp2's stacked components, with the engine's 16-bit
limbs (..., 24) last (field/limbs.py):

    Fp2   (..., 2, L)           c0 + c1 u,            u^2 = -1
    Fp6   (..., 3, 2, L)        c0 + c1 v + c2 v^2,   v^3 = xi = u + 1
    Fp12  (..., 2, 3, 2, L)     c0 + c1 w,            w^2 = v

the tower of curve/pairing.py. Values are redundant. Every public
function takes fresh values (`limbs.mul_lazy` outputs: limbs near
[0, 2^16), value in (-p, 2p)) and returns fresh ones, by one `renorm` (a
product by Montgomery one) at its end; inside, sums of at most a few dozen
fresh values enter the products, far inside mul_lazy's limits. The
products of a step are stacked into one mul_lazy call. `to_words` gives
canonical Montgomery words, the kernels' output form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fp, limbs

P = fp.SPEC.modulus
L = fp.SPEC.n_limbs


@functools.lru_cache(maxsize=None)
def _one(device) -> torch.Tensor:
    return torch.tensor(limbs.int_to_limbs(fp.SPEC.one_mont, L),
                        dtype=torch.int64, device=device)


def mul(a, b):
    """Fp products, a and b broadcast: one mul_lazy."""
    a, b = torch.broadcast_tensors(a, b)
    return limbs.mul_lazy(limbs.consts(fp.SPEC, a.device), a, b)


def renorm(v):
    """A redundant value (up to ~2^22 a limb) -> a fresh one, the same
    element: a product by Montgomery one."""
    return mul(v, _one(v.device))


def from_words(w) -> torch.Tensor:
    return limbs.words_to_limbs(w)


def to_words(v) -> torch.Tensor:
    """Redundant limbs -> canonical int32 Montgomery words."""
    return limbs.limbs_to_words(
        limbs.canon_wide(limbs.consts(fp.SPEC, v.device), v))


def fp_inv(a):
    """a^(p-2) by square-and-multiply over the static exponent (MSB
    first); 0 -> 0."""
    acc = a
    for bit in bin(P - 2)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


# ---- Fp2 ----
def f2(c0, c1):
    return torch.stack(torch.broadcast_tensors(c0, c1), dim=-2)


def f2_mul_raw(a, b):
    """Karatsuba: 3 Fp products in one mul_lazy; output not renormed."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    t0, t1, t2 = mul(torch.stack((a0, a1, a0 + a1)),
                     torch.stack((b0, b1, b0 + b1))).unbind(0)
    return f2(t0 - t1, t2 - t0 - t1)


def f2_mul(a, b):
    return renorm(f2_mul_raw(a, b))


def f2_mul_fp(a, x):
    """Fp2 a times Fp x (..., L): 2 products."""
    return mul(a, x.unsqueeze(-2))


def f2_mul_xi(a):
    """(a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return f2(a0 - a1, a0 + a1)


def f2_conj(a):
    return f2(a[..., 0, :], -a[..., 1, :])


def f2_inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2); 0 -> 0."""
    sq = mul(a, a)
    ninv = fp_inv(renorm(sq[..., 0, :] + sq[..., 1, :]))
    return f2_mul_fp(f2_conj(a), ninv)


# ---- Fp6 ----
def f6(c0, c1, c2):
    return torch.stack(torch.broadcast_tensors(c0, c1, c2), dim=-3)


def f6_mul_raw(a, b):
    """The 6-product Karatsuba form of pairing.F6.__mul__, all six Fp2
    products in one f2_mul_raw; output not renormed."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-3)
    b0, b1, b2 = b.unbind(-3)
    t = f2_mul_raw(torch.stack((a0, a1, a2, a1 + a2, a0 + a1, a0 + a2)),
                   torch.stack((b0, b1, b2, b1 + b2, b0 + b1, b0 + b2)))
    t0, t1, t2, m12, m01, m02 = t.unbind(0)
    return f6(f2_mul_xi(m12 - t1 - t2) + t0,
              m01 - t0 - t1 + f2_mul_xi(t2),
              m02 - t0 - t2 + t1)


def f6_mul_v(a):
    """(c0, c1, c2) v = (xi c2, c0, c1)."""
    a0, a1, a2 = a.unbind(-3)
    return f6(f2_mul_xi(a2), a0, a1)


def f6_inv(a):
    """pairing.F6.inv: t0 = a^2 - xi bc, t1 = xi c^2 - ab, t2 = b^2 - ac,
    then one Fp2 inverse of a t0 + xi (c t1 + b t2)."""
    a0, a1, a2 = a.unbind(-3)
    s = f2_mul_raw(torch.stack((a0, a1, a2, a0, a1, a0)),
                   torch.stack((a0, a2, a2, a1, a1, a2)))
    sq_a, bc, sq_c, ab, sq_b, ac = s.unbind(0)
    t0 = renorm(sq_a - f2_mul_xi(bc))
    t1 = renorm(f2_mul_xi(sq_c) - ab)
    t2 = renorm(sq_b - ac)
    u = f2_mul_raw(torch.stack((a0, a2, a1)), torch.stack((t0, t1, t2)))
    dinv = f2_inv(renorm(u[0] + f2_mul_xi(u[1] + u[2])))
    return renorm(f2_mul_raw(torch.stack((t0, t1, t2), dim=-3),
                             dinv.unsqueeze(-3)))


# ---- Fp12 ----
def f12(c0, c1):
    return torch.stack(torch.broadcast_tensors(c0, c1), dim=-4)


def f12_one(shape, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (2, 3, 2, L), dtype=torch.int64,
                      device=device)
    out[..., 0, 0, 0, :] = _one(device)
    return out


def f12_mul(a, b):
    """Karatsuba over Fp6: the three Fp6 products in one f6_mul_raw (one
    mul_lazy of 54 Fp products)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a.unbind(-4)
    b0, b1 = b.unbind(-4)
    t0, t1, tm = f6_mul_raw(torch.stack((a0, a1, a0 + a1)),
                            torch.stack((b0, b1, b0 + b1))).unbind(0)
    return renorm(f12(t0 + f6_mul_v(t1), tm - t0 - t1))


def f12_sqr(a):
    """(a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w from the two Fp6
    products a0 a1 and (a0 + a1)(a0 + v a1)."""
    a0, a1 = a.unbind(-4)
    ab, q = f6_mul_raw(torch.stack((a0, a0 + a1)),
                       torch.stack((a1, a0 + f6_mul_v(a1)))).unbind(0)
    return renorm(f12(q - ab - f6_mul_v(ab), ab + ab))


def f12_cyclotomic_sqr(a):
    """a^2 for a in the cyclotomic subgroup (after the final
    exponentiation's easy part), Granger-Scott: with
    (z0, z4, z3) = a0, (z2, z1, z5) = a1, three Fp4 squarings of (z0, z1),
    (z2, z3), (z4, z5), each (xi t1 + t0, t2 - t0 - t1) from the Fp2 squares
    t0, t1, t2 of its halves and their sum; the 9 squares (2 Fp products
    each) in one mul_lazy. z0' = 3 A0 - 2 z0, z1' = 3 A1 + 2 z1,
    z4' = 3 B0 - 2 z4, z5' = 3 B1 + 2 z5, z2' = 3 xi C1 + 2 z2,
    z3' = 3 C0 - 2 z3 (A, B, C the three Fp4 squares)."""
    z0, z4, z3 = a[..., 0, :, :, :].unbind(-3)
    z2, z1, z5 = a[..., 1, :, :, :].unbind(-3)
    base = torch.stack((z0, z1, z0 + z1, z2, z3, z2 + z3, z4, z5, z4 + z5))
    b0, b1 = base[..., 0, :], base[..., 1, :]
    s, t = mul(torch.stack((b0 + b1, b0)),
               torch.stack((b0 - b1, b1))).unbind(0)
    sq = renorm(f2(s, 2 * t))
    fp4 = [(f2_mul_xi(sq[3 * p + 1]) + sq[3 * p],
            sq[3 * p + 2] - sq[3 * p] - sq[3 * p + 1]) for p in range(3)]
    (a0, a1), (b0, b1), (c0, c1) = fp4
    return renorm(f12(f6(3 * a0 - 2 * z0, 3 * b0 - 2 * z4, 3 * c0 - 2 * z3),
                      f6(3 * f2_mul_xi(c1) + 2 * z2, 3 * a1 + 2 * z1,
                         3 * b1 + 2 * z5)))


def f12_conj(a):
    """Conjugation over Fp6: the p^6 Frobenius."""
    return f12(a[..., 0, :, :, :], -a[..., 1, :, :, :])


def f12_inv(a):
    """pairing.F12.inv: (c0 - c1 w) / (c0^2 - v c1^2)."""
    a0, a1 = a.unbind(-4)
    sq = renorm(f6_mul_raw(torch.stack((a0, a1)), torch.stack((a0, a1))))
    d = f6_inv(renorm(sq[0] - f6_mul_v(sq[1])))
    prod = f6_mul_raw(torch.stack((a0, a1)), d)
    return renorm(f12(prod[0], -prod[1]))


def frobenius(a, gammas, odd: bool):
    """a^(p^k): each Fp2 slot conjugated when k is odd, then times its
    gamma (gammas (2, 3, 2, L), pairing_kernels.frobenius_gammas)."""
    if odd:
        a = torch.stack((a[..., 0, :], -a[..., 1, :]), dim=-2)
    return renorm(f2_mul_raw(a, gammas))


def f12_is_one(words) -> torch.Tensor:
    """Canonical Fp12 words (..., 2, 3, 2, 12) -> bool (...)."""
    one = torch.zeros(words.shape[-4:], dtype=words.dtype,
                      device=words.device)
    one[0, 0, 0] = fp.SPEC.words([fp.SPEC.one_mont], words.device)[0]
    return (words == one).flatten(-4).all(-1)


# ---- host conversions (tests, and the gammas) ----
def f12_from_int(vals, device="cuda") -> torch.Tensor:
    """pairing.F12 objects (or one) -> Montgomery words
    (..., 2, 3, 2, 12)."""
    def ints(x):
        return [[[c.a, c.b] for c in (s.c0, s.c1, s.c2)]
                for s in (x.c0, x.c1)]

    single = not isinstance(vals, (list, tuple))
    arr = np.asarray([ints(v) for v in ([vals] if single else vals)],
                     dtype=object)
    out = fp.from_int(arr, device)
    return out[0] if single else out


def f12_to_oracle(words) -> list:
    """Montgomery words (n, 2, 3, 2, 12) -> [pairing.F12]."""
    from .pairing import F2, F6, F12

    ints = fp.to_int(words.reshape(-1, 2, 3, 2, fp.N_WORDS))
    return [F12(*(F6(*(F2(int(c[0]), int(c[1])) for c in s)) for s in x))
            for x in ints]
