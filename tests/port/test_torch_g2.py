"""G2 in the port: Fp2 against kzg_tpu.utils.host_ec and kzg_tpu.curve.fp2,
the generic Jacobian ops over Fp2 against host_ec's G2, and K-a
(`g2_scalar_mul`)'s plain version against host g2_mul, with infinity and
the scalars 0, 1 and r - 1. Exact: canonical ints, points in affine
form."""

import numpy as np
import pytest
from port_helpers import CPU, random_ints

from kzg_tpu.curve import fp2 as jfp2
from kzg_tpu.utils import host_ec as jhost
from kzg_tpu_torch.curve import fp2, g2
from kzg_tpu_torch.curve import pairing_kernels as pk
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.field.constants import FP_MODULUS, FR_MODULUS
from kzg_tpu_torch.utils import host_ec

F2 = host_ec._Fp2Field
Q = host_ec.g2_generator()


def ints(t) -> list:
    return [tuple(int(v) for v in row) for row in fp2.to_int(t)]


def pairs(seed: int, n: int) -> list:
    v = random_ints(np.random.default_rng(seed), 2 * n, FP_MODULUS)
    v[:4] = [0, 1, FP_MODULUS - 1, FP_MODULUS - 1]
    return [(v[2 * i], v[2 * i + 1]) for i in range(n)]


def test_fp2_ops_match_host_and_reference():
    a, b = pairs(1, 6), pairs(2, 6)
    ta, tb = fp2.from_int(a, CPU), fp2.from_int(b, CPU)
    assert ints(fp2.mul(ta, tb)) == [F2.mul(x, y) for x, y in zip(a, b)]
    assert ints(fp2.sqr(ta)) == [F2.mul(x, x) for x in a]
    assert ints(fp2.add(ta, tb)) == [F2.add(x, y) for x, y in zip(a, b)]
    assert ints(fp2.sub(ta, tb)) == [F2.sub(x, y) for x, y in zip(a, b)]
    nz = [x for x in a if x != (0, 0)]
    assert ints(fp2.inv(fp2.from_int(nz, CPU))) == [F2.inv(x) for x in nz]
    assert ints(fp2.batch_inv(ta)) == [(0, 0) if x == (0, 0) else F2.inv(x)
                                       for x in a]
    # the JAX package's fp2 on the same values (eager, a few ops)
    ja, jb = jfp2.from_int(a), jfp2.from_int(b)
    assert ints(fp2.mul(ta, tb)) == [tuple(int(v) for v in r) for r in
                                     jfp2.to_int(np.asarray(jfp2.mul(ja, jb)))]


def test_g2_ops_match_host():
    ks = [3, 7, 12345]
    a = [host_ec.g2_mul(Q, k) for k in ks] + [None]
    b = [host_ec.g2_mul(Q, 5), host_ec.g2_neg(a[1]), a[2], a[0]]
    pa, pb = g2.from_affine_ints(a, CPU), g2.from_affine_ints(b, CPU)
    assert g2.to_affine_ints(g2.add(pa, pb)) == \
        [host_ec.g2_add(x, y) for x, y in zip(a, b)]
    assert g2.to_affine_ints(g2.sub(pa, pb)) == \
        [host_ec.g2_sub(x, y) for x, y in zip(a, b)]
    assert g2.to_affine_ints(g2.double(pa)) == \
        [host_ec.g2_add(x, x) for x in a]
    assert g2.to_affine_ints(g2.mul_small(pa, 5)) == \
        [host_ec.g2_mul(x, 5) if x else None for x in a]
    assert g2.eq(pa, g2.add(pa, g2.infinity((4,), CPU))).all()
    assert g2.to_affine_ints(g2.generator((1,), CPU)) == [Q] == \
        [jhost.g2_generator()]


def test_g2_scalar_mul_plain_matches_host():
    """K-a's plain version: random scalars, 0, 1, r-1 and an infinity
    lane (Z = 0), against host g2_mul."""
    ks = random_ints(np.random.default_rng(5), 2, FR_MODULUS) + \
        [0, 1, FR_MODULUS - 1]
    qs = [host_ec.g2_mul(Q, 11), host_ec.g2_mul(Q, 13), Q, Q, None]
    p = g2.from_affine_ints(qs, CPU)
    pk.reset_launches()
    out = g2.mul(p, fr.from_int(ks, CPU))    # its plain version on the CPU
    assert pk.LAUNCHES["g2_scalar_mul"] == 0
    assert g2.to_affine_ints(out) == [
        host_ec.g2_mul(q, k) if q else None for q, k in zip(qs, ks)]
    # the infinity lane leaves as all-zero words, as K3's does
    assert not out.z[4].any() and not out.x[4].any()
