"""BLS12-381 ate pairing over the Fp12 tower on exact Python integers (the
port's copy of kzg_tpu/curve/pairing.py, which it may not import).

The host oracle of every pairing test: tower arithmetic Fp2/Fp6/Fp12, an
affine Miller loop over the untwisted G2 point and the full final
exponentiation, all on Python ints. `pairings_verify` checks a product of
two pairings on the native library (curve/pairing_native.py); the Python
tower is called by name (`pairings_verify_python`) where a test wants it.

Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3-(u+1)); Fp12 = Fp6[w]/(w^2-v).
"""

from __future__ import annotations

from ..field.constants import BLS_X, FP_MODULUS, FR_MODULUS

P = FP_MODULUS


# ---------- Fp2 ----------
class F2:
    __slots__ = ("a", "b")  # a + b*u

    def __init__(self, a, b):
        self.a = a % P
        self.b = b % P

    ZERO = None  # set below
    ONE = None

    def __add__(s, o):
        return F2(s.a + o.a, s.b + o.b)

    def __sub__(s, o):
        return F2(s.a - o.a, s.b - o.b)

    def __neg__(s):
        return F2(-s.a, -s.b)

    def __mul__(s, o):
        if isinstance(o, int):
            return F2(s.a * o, s.b * o)
        t0 = s.a * o.a
        t1 = s.b * o.b
        t2 = (s.a + s.b) * (o.a + o.b)
        return F2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def sqr(s):
        return F2((s.a + s.b) * (s.a - s.b), 2 * s.a * s.b)

    def inv(s):
        n = pow(s.a * s.a + s.b * s.b, -1, P)
        return F2(s.a * n, -s.b * n)

    def conj(s):
        return F2(s.a, -s.b)

    def mul_xi(s):
        """Multiply by xi = u + 1 (the Fp6 non-residue)."""
        return F2(s.a - s.b, s.a + s.b)

    def is_zero(s):
        return s.a == 0 and s.b == 0

    def __eq__(s, o):
        return s.a == o.a and s.b == o.b

    def __hash__(s):
        return hash((s.a, s.b))


F2.ZERO = F2(0, 0)
F2.ONE = F2(1, 0)


# ---------- Fp6 ----------
class F6:
    __slots__ = ("c0", "c1", "c2")  # c0 + c1*v + c2*v^2

    def __init__(self, c0, c1, c2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(s, o):
        return F6(s.c0 + o.c0, s.c1 + o.c1, s.c2 + o.c2)

    def __sub__(s, o):
        return F6(s.c0 - o.c0, s.c1 - o.c1, s.c2 - o.c2)

    def __neg__(s):
        return F6(-s.c0, -s.c1, -s.c2)

    def __mul__(s, o):
        if isinstance(o, int):
            return F6(s.c0 * o, s.c1 * o, s.c2 * o)
        a0, a1, a2 = s.c0, s.c1, s.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return F6(c0, c1, c2)

    __rmul__ = __mul__

    def sqr(s):
        return s * s

    def mul_v(s):
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
        return F6(s.c2.mul_xi(), s.c0, s.c1)

    def inv(s):
        a, b, c = s.c0, s.c1, s.c2
        t0 = a.sqr() - (b * c).mul_xi()
        t1 = c.sqr().mul_xi() - a * b
        t2 = b.sqr() - a * c
        denom = a * t0 + (c * t1 + b * t2).mul_xi()
        dinv = denom.inv()
        return F6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(s):
        return s.c0.is_zero() and s.c1.is_zero() and s.c2.is_zero()

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1 and s.c2 == o.c2

    def __hash__(s):
        return hash((s.c0, s.c1, s.c2))


F6.ZERO = F6(F2.ZERO, F2.ZERO, F2.ZERO)
F6.ONE = F6(F2.ONE, F2.ZERO, F2.ZERO)


# ---------- Fp12 ----------
class F12:
    __slots__ = ("c0", "c1")  # c0 + c1*w

    def __init__(self, c0, c1):
        self.c0, self.c1 = c0, c1

    def __add__(s, o):
        return F12(s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return F12(s.c0 - o.c0, s.c1 - o.c1)

    def __neg__(s):
        return F12(-s.c0, -s.c1)

    def __mul__(s, o):
        if isinstance(o, int):
            return F12(s.c0 * o, s.c1 * o)
        t0 = s.c0 * o.c0
        t1 = s.c1 * o.c1
        c0 = t0 + t1.mul_v()
        c1 = (s.c0 + s.c1) * (o.c0 + o.c1) - t0 - t1
        return F12(c0, c1)

    __rmul__ = __mul__

    def sqr(s):
        return s * s

    def inv(s):
        denom = (s.c0 * s.c0 - (s.c1 * s.c1).mul_v()).inv()
        return F12(s.c0 * denom, -(s.c1 * denom))

    def conj(s):
        """Conjugation over Fp6 = the p^6 Frobenius."""
        return F12(s.c0, -s.c1)

    def pow(s, e: int):
        if e < 0:
            return s.inv().pow(-e)
        acc = F12.ONE
        for bit in bin(e)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * s
        return acc

    def is_one(s):
        return s == F12.ONE

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1

    def __hash__(s):
        return hash((s.c0, s.c1))


F12.ZERO = F12(F6.ZERO, F6.ZERO)
F12.ONE = F12(F6.ONE, F6.ZERO)
# w as an Fp12 element
F12.W = F12(F6.ZERO, F6.ONE)


def f12_scalar(x: int) -> F12:
    return F12(F6(F2(x, 0), F2.ZERO, F2.ZERO), F6.ZERO)


def f12_from_fp2(x: F2) -> F12:
    return F12(F6(x, F2.ZERO, F2.ZERO), F6.ZERO)


# ---------- curve over Fp12 (affine, None = infinity) ----------
def _ec_double(pt):
    x, y = pt
    m = x.sqr() * 3 * (y * 2).inv()
    x3 = m.sqr() - x * 2
    y3 = m * (x - x3) - y
    return (x3, y3)


def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _ec_double(p1)
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    x3 = m.sqr() - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _line(p1, p2, t):
    """Evaluate the line through p1, p2 at point t (all affine Fp12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 == x2 and y1 == y2:
        m = x1.sqr() * 3 * (y1 * 2).inv()
        return yt - y1 - m * (xt - x1)
    if x1 == x2:
        return xt - x1
    m = (y2 - y1) * (x2 - x1).inv()
    return yt - y1 - m * (xt - x1)


# ---------- untwist ----------
_W2_INV = (F12.W * F12.W).inv()
_W3_INV = (F12.W * F12.W * F12.W).inv()


def untwist(q_affine):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x / w^2, y / w^3)."""
    if q_affine is None:
        return None
    x, y = q_affine
    return (f12_from_fp2(x) * _W2_INV, f12_from_fp2(y) * _W3_INV)


def _on_curve_fp12(pt) -> bool:
    x, y = pt
    return y.sqr() == x * x * x + f12_scalar(4)


# ---------- pairing ----------
def miller_loop(q12, p12) -> F12:
    """f_{|x|, Q}(P) with the BLS parameter; inverts at the end for x < 0."""
    if q12 is None or p12 is None:
        return F12.ONE
    u = -BLS_X  # positive
    t = q12
    f = F12.ONE
    for bit in bin(u)[3:]:  # skip the leading 1
        f = f * f * _line(t, t, p12)
        t = _ec_double(t)
        if bit == "1":
            f = f * _line(t, q12, p12)
            t = _ec_add(t, q12)
    return f.inv()  # x < 0


FINAL_EXP = (P**12 - 1) // FR_MODULUS


def final_exponentiation(f: F12) -> F12:
    return f.pow(FINAL_EXP)


def _g1_to_fp12(p_affine):
    if p_affine is None:
        return None
    x, y = p_affine
    return (f12_scalar(x), f12_scalar(y))


def _g2_to_fp12(q_affine):
    if q_affine is None:
        return None
    (x0, x1), (y0, y1) = q_affine
    pt = untwist((F2(x0, x1), F2(y0, y1)))
    assert _on_curve_fp12(pt), "untwisted G2 point not on E(Fp12)"
    return pt


def pairing(p_affine, q_affine, final_exp: bool = True) -> F12:
    """e(P, Q) with P in G1 ((x, y) ints or None), Q in G2
    (((x0,x1),(y0,y1)) ints or None)."""
    f = miller_loop(_g2_to_fp12(q_affine), _g1_to_fp12(p_affine))
    return final_exponentiation(f) if final_exp else f


def pairings_verify_python(a1, a2, b1, b2) -> bool:
    """e(a1, a2) * e(b1, b2) == 1 on this module's exact tower. Points in
    affine int form (None = infinity)."""
    f1 = miller_loop(_g2_to_fp12(a2), _g1_to_fp12(a1))
    f2 = miller_loop(_g2_to_fp12(b2), _g1_to_fp12(b1))
    return final_exponentiation(f1 * f2).is_one()


def pairings_verify(a1, a2, b1, b2) -> bool:
    """e(a1, a2) * e(b1, b2) == 1 (reference: PairingsVerify,
    bls/bls_kilic.go:153-158) on the native library, built from
    native/pairing.cpp at first use; raises if it does not build."""
    from . import pairing_native

    return pairing_native.pairings_verify(a1, a2, b1, b2)
