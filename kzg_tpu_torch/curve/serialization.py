"""Compressed point (de)serialization, ZCash/IETF format (the port's copy
of kzg_tpu/curve/serialization.py; `decompress_g1_batch` runs on the
card).

Parity with ToCompressedG1/FromCompressedG1 (bls/bls_kilic.go:114-130) and
the hex text marshalling (bls/bls_all.go:20-61). 48 bytes for G1, 96 for
G2, big-endian x with 3 flag bits in the top byte:
  bit7 (0x80): compressed flag (always set here)
  bit6 (0x40): infinity flag
  bit5 (0x20): sign of y (set if y > (p-1)/2)
Decompression needs a square root in Fp; p == 3 (mod 4) so
sqrt(a) = a^((p+1)/4).
"""

from __future__ import annotations

import torch

from ..field import fp
from ..field.constants import CURVE_B, FP_MODULUS, FR_MODULUS
from ..utils import host_ec
from . import g1 as g1mod
from .weierstrass import JacobianPoint

P = FP_MODULUS


def _sqrt_fp(a: int):
    r = pow(a, (P + 1) // 4, P)
    if r * r % P != a % P:
        return None
    return r


def _sqrt_fp2(a0: int, a1: int):
    """Square root in Fp2 via norm trick; returns (r0, r1) or None."""
    if a1 == 0:
        r = _sqrt_fp(a0)
        if r is not None:
            return (r, 0)
        # a0 is a non-residue: sqrt is purely imaginary, a0 = -(r1^2)
        r = _sqrt_fp((-a0) % P)
        if r is None:
            return None
        return (0, r)
    # norm = a0^2 + a1^2 must be a QR in Fp
    n = _sqrt_fp((a0 * a0 + a1 * a1) % P)
    if n is None:
        return None
    for nn in (n, (-n) % P):
        d = (a0 + nn) * pow(2, -1, P) % P
        r0 = _sqrt_fp(d)
        if r0 is None:
            continue
        if r0 == 0:
            continue
        r1 = a1 * pow(2 * r0, -1, P) % P
        if (r0 * r0 - r1 * r1) % P == a0 % P and (2 * r0 * r1) % P == a1 % P:
            return (r0, r1)
    return None


def g1_in_subgroup(affine) -> bool:
    """r-torsion membership: [r]P == O. BLS12-381's G1 cofactor is
    ~2^125, so on-curve does NOT imply in-subgroup; the reference's
    FromCompressedG1 rejects wrong-subgroup points via kilic
    (bls/bls_kilic.go:122-130) and every verify entry point depends on
    it (consensus security, not a nicety)."""
    return affine is None or host_ec.g1_mul(affine, FR_MODULUS) is None


def g2_in_subgroup(affine) -> bool:
    """r-torsion membership for G2 (cofactor ~2^380)."""
    return affine is None or host_ec.g2_mul(affine, FR_MODULUS) is None


def compress_g1(affine) -> bytes:
    """(x, y) ints or None (infinity) -> 48 bytes."""
    if affine is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = affine
    flags = 0x80
    if y > (P - 1) // 2:
        flags |= 0x20
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def decompress_g1(data: bytes):
    """48 bytes -> (x, y) ints or None (infinity). Raises on invalid."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed form not supported")
    if flags & 0x40:
        if any(data[1:]) or (flags & 0x3F):
            raise ValueError("invalid infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y2 = (pow(x, 3, P) + CURVE_B) % P
    y = _sqrt_fp(y2)
    if y is None:
        raise ValueError("point not on curve")
    y_is_big = y > (P - 1) // 2
    if bool(flags & 0x20) != y_is_big:
        y = (P - y) % P
    if not g1_in_subgroup((x, y)):
        raise ValueError("point not in the r-order subgroup")
    return (x, y)


def decompress_g1_batch(datas, subgroup_check: bool = True,
                        device="cuda"):
    """FromCompressedG1 over N 48-byte encodings at once
    (kzg_tpu/curve/serialization.py:116-200): the flags are parsed on the
    host; the square roots y = (x^3 + 4)^((p+1)/4) are one `fr_pow` launch,
    the on-curve test a K1 square, and the subgroup test [r - 1]P == -P
    one K3 launch (g1.in_subgroup). Returns a list of affine (x, y) ints
    or None; raises ValueError if any entry is invalid."""
    xs, signs, infs = [], [], []
    for d in datas:
        d = bytes(d)
        if len(d) != 48:
            raise ValueError("G1 compressed point must be 48 bytes")
        flags = d[0]
        if not flags & 0x80:
            raise ValueError("uncompressed form not supported")
        if flags & 0x40:
            if any(d[1:]) or (flags & 0x3F):
                raise ValueError("invalid infinity encoding")
            infs.append(True)
            xs.append(0)
            signs.append(False)
            continue
        x = int.from_bytes(bytes([flags & 0x1F]) + d[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        infs.append(False)
        xs.append(x)
        signs.append(bool(flags & 0x20))
    if not xs:
        return []
    x = fp.from_int(xs, device)
    y2 = fp.add(fp.mul(fp.sqr(x), x), fp.from_int(CURVE_B, device))
    y = fp.pow_static(y2, (P + 1) // 4)
    on_curve = fp.eq(fp.sqr(y), y2)
    if subgroup_check:
        ok_sub = g1mod.in_subgroup(JacobianPoint(x, y, fp.one_like(x)))
    else:
        ok_sub = torch.ones_like(on_curve)
    y_ints = fp.to_int(y)
    on_curve = on_curve.cpu().numpy()
    ok_sub = ok_sub.cpu().numpy()

    out = []
    for i, inf in enumerate(infs):
        if inf:
            out.append(None)
            continue
        if not bool(on_curve[i]):
            raise ValueError("point not on curve")
        if not bool(ok_sub[i]):
            raise ValueError("point not in the r-order subgroup")
        yi = int(y_ints[i])
        if signs[i] != (yi > (P - 1) // 2):
            yi = (P - yi) % P
        out.append((xs[i], yi))
    return out


def compress_g2(affine) -> bytes:
    """((x0,x1),(y0,y1)) ints or None -> 96 bytes (x1 first, per spec)."""
    if affine is None:
        out = bytearray(96)
        out[0] = 0xC0
        return bytes(out)
    (x0, x1), (y0, y1) = affine
    flags = 0x80
    if y1 > (P - 1) // 2 or (y1 == 0 and y0 > (P - 1) // 2):
        flags |= 0x20
    b = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def decompress_g2(data: bytes):
    """96 bytes -> ((x0,x1),(y0,y1)) ints or None. Raises on invalid."""
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed form not supported")
    if flags & 0x40:
        if any(data[1:]) or (flags & 0x3F):
            raise ValueError("invalid infinity encoding")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("x out of range")
    # y^2 = x^3 + 4(u+1) in Fp2
    x0_3 = (x0 * (x0 * x0 - 3 * x1 * x1)) % P
    x1_3 = (x1 * (3 * x0 * x0 - x1 * x1)) % P
    y2 = ((x0_3 + 4) % P, (x1_3 + 4) % P)
    y = _sqrt_fp2(*y2)
    if y is None:
        raise ValueError("point not on curve")
    y0, y1 = y
    y_is_big = y1 > (P - 1) // 2 or (y1 == 0 and y0 > (P - 1) // 2)
    if bool(flags & 0x20) != y_is_big:
        y0, y1 = (P - y0) % P, (P - y1) % P
        if y0 == P:
            y0 = 0
        if y1 == P:
            y1 = 0
    if not g2_in_subgroup(((x0, x1), (y0, y1))):
        raise ValueError("point not in the r-order subgroup")
    return ((x0, x1), (y0, y1))


def g1_to_hex(affine) -> str:
    """MarshalText parity (bls/bls_all.go:20-32)."""
    return compress_g1(affine).hex()


def g1_from_hex(s: str):
    return decompress_g1(bytes.fromhex(s))


def g2_to_hex(affine) -> str:
    return compress_g2(affine).hex()


def g2_from_hex(s: str):
    return decompress_g2(bytes.fromhex(s))
