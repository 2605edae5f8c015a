"""Exact host-side BLS12-381 curve arithmetic over Python integers (the
port's copy of kzg_tpu/utils/host_ec.py).

Off the hot path only: the testing setup, the few point operations of a
host pairing check, and an independent oracle for the device results.
Points are affine tuples of ints (G1: (x, y), G2: ((x0, x1), (y0, y1))),
None = infinity.
"""

from __future__ import annotations

from ..field.constants import (
    FP_MODULUS,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
)

P = FP_MODULUS


# ---------------- generic affine ops over a pluggable field ----------------
class _FpField:
    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def eq(a, b):
        return a % P == b % P

    @staticmethod
    def neg(a):
        return (-a) % P

    @staticmethod
    def muli(a, k):
        return a * k % P


class _Fp2Field:
    """Fp2 = Fp[u]/(u^2+1), elements as (c0, c1) int tuples."""

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0 = a[0] * b[0]
        t1 = a[1] * b[1]
        t2 = (a[0] + a[1]) * (b[0] + b[1])
        return ((t0 - t1) % P, (t2 - t0 - t1) % P)

    @staticmethod
    def inv(a):
        n = pow(a[0] * a[0] + a[1] * a[1], -1, P)
        return (a[0] * n % P, (-a[1]) * n % P)

    @staticmethod
    def eq(a, b):
        return a[0] % P == b[0] % P and a[1] % P == b[1] % P

    @staticmethod
    def neg(a):
        return ((-a[0]) % P, (-a[1]) % P)

    @staticmethod
    def muli(a, k):
        return (a[0] * k % P, a[1] * k % P)


def _add(F, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if F.eq(x1, x2):
        if F.eq(y1, y2):
            return _double(F, p)
        return None
    m = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(m, m), x1), x2)
    y3 = F.sub(F.mul(m, F.sub(x1, x3)), y1)
    return (x3, y3)


def _double(F, p):
    if p is None:
        return None
    x, y = p
    m = F.mul(F.muli(F.mul(x, x), 3), F.inv(F.muli(y, 2)))
    x3 = F.sub(F.mul(m, m), F.muli(x, 2))
    y3 = F.sub(F.mul(m, F.sub(x, x3)), y)
    return (x3, y3)


def _one(F):
    return 1 if F is _FpField else (1, 0)


def _jac_double(F, p):
    """dbl-2009-l (a=0) on (X, Y, Z); None = infinity."""
    if p is None:
        return None
    X, Y, Z = p
    A = F.mul(X, X)
    B = F.mul(Y, Y)
    C = F.mul(B, B)
    D = F.muli(F.sub(F.mul(F.add(X, B), F.add(X, B)), F.add(A, C)), 2)
    E = F.muli(A, 3)
    Fv = F.mul(E, E)
    X3 = F.sub(Fv, F.muli(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.muli(C, 8))
    Z3 = F.muli(F.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add(F, p, q):
    """add-2007-bl on Jacobian points; falls back to double / infinity."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.mul(Z1, Z1)
    Z2Z2 = F.mul(Z2, Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    R = F.sub(S2, S1)
    if F.eq(H, F.sub(H, H)):  # H == 0
        if F.eq(R, F.sub(R, R)):
            return _jac_double(F, p)
        return None
    I = F.mul(F.muli(H, 2), F.muli(H, 2))
    J = F.mul(H, I)
    r2 = F.muli(R, 2)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.mul(r2, r2), J), F.muli(V, 2))
    Y3 = F.sub(F.mul(r2, F.sub(V, X3)), F.muli(F.mul(S1, J), 2))
    Z3 = F.mul(F.sub(F.mul(F.add(Z1, Z2), F.add(Z1, Z2)),
                     F.add(Z1Z1, Z2Z2)), H)
    return (X3, Y3, Z3)


def _jac_to_affine(F, p):
    if p is None:
        return None
    X, Y, Z = p
    zero = F.sub(Z, Z)
    if F.eq(Z, zero):
        return None
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return (F.mul(X, zi2), F.mul(Y, F.mul(zi, zi2)))


def _mul(F, p, k: int):
    if k < 0:
        raise ValueError("negative scalar")
    if p is None or k == 0:
        return None
    jp = (p[0], p[1], _one(F))
    acc = None
    while k:
        if k & 1:
            acc = _jac_add(F, acc, jp)
        jp = _jac_double(F, jp)
        k >>= 1
    return _jac_to_affine(F, acc)


def _neg(F, p):
    if p is None:
        return None
    return (p[0], F.neg(p[1]))


# ---------------- public G1/G2 wrappers ----------------
def g1_add(p, q):
    return _add(_FpField, p, q)


def g1_mul(p, k: int):
    return _mul(_FpField, p, k)


def g1_neg(p):
    return _neg(_FpField, p)


def g1_sub(p, q):
    return _add(_FpField, p, g1_neg(q))


def g2_add(p, q):
    return _add(_Fp2Field, p, q)


def g2_mul(p, k: int):
    return _mul(_Fp2Field, p, k)


def g2_neg(p):
    return _neg(_Fp2Field, p)


def g2_sub(p, q):
    return _add(_Fp2Field, p, g2_neg(q))


def g1_generator():
    return (G1_GENERATOR_X, G1_GENERATOR_Y)


def g2_generator():
    return (tuple(G2_GENERATOR_X), tuple(G2_GENERATOR_Y))
