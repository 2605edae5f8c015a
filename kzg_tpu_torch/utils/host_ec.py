"""Exact host-side G1 arithmetic over Python integers (the port's copy of
the G1 half of kzg_tpu/utils/host_ec.py).

Off the hot path only: the testing setup and an independent oracle for
the device results. Points are affine (x, y) int tuples, None = infinity.
"""

from __future__ import annotations

from ..field.constants import FP_MODULUS, G1_GENERATOR_X, G1_GENERATOR_Y

P = FP_MODULUS


def _jac_double(p):
    """dbl-2009-l (a = 0) on (X, Y, Z); None = infinity."""
    if p is None:
        return None
    X, Y, Z = p
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def _jac_add(p, q):
    """add-2007-bl; falls back to double / infinity."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    if H == 0:
        return _jac_double(p) if R == 0 else None
    I = 4 * H * H % P
    J = H * I % P
    r2 = 2 * R % P
    V = U1 * I % P
    X3 = (r2 * r2 - J - 2 * V) % P
    Y3 = (r2 * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def _to_affine(p):
    if p is None or p[2] % P == 0:
        return None
    zi = pow(p[2], -1, P)
    zi2 = zi * zi % P
    return (p[0] * zi2 % P, p[1] * zi2 * zi % P)


def g1_generator():
    return (G1_GENERATOR_X, G1_GENERATOR_Y)


def g1_add(p, q):
    return _to_affine(_jac_add(None if p is None else (*p, 1),
                               None if q is None else (*q, 1)))


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % P)


def g1_mul(p, k: int):
    if k < 0:
        raise ValueError("negative scalar")
    if p is None or k == 0:
        return None
    jp = (p[0], p[1], 1)
    acc = None
    while k:
        if k & 1:
            acc = _jac_add(acc, jp)
        jp = _jac_double(jp)
        k >>= 1
    return _to_affine(acc)
