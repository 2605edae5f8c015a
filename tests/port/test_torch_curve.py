"""The port's G1 layer against the JAX package (its recorded outputs,
port_helpers.py) and the host oracle: the complete Jacobian formulas,
`g1.mul` (K3), the G1 FFT (K4 stages and the 1/n butterfly),
`tree_reduce` and the GLV digit split."""

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    fft_g1_case,
    mul_case,
    random_ints,
    reference,
    ref_to_port,
    subgroup_affine,
    tree_reduce_case,
    with_zero_infinity,
)

from kzg_tpu.curve import g1 as jg1
from kzg_tpu.curve import glv as jglv
from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1, glv
from kzg_tpu_torch.curve import kernels as gk
from kzg_tpu_torch.curve.fft_g1 import fft_g1
from kzg_tpu_torch.curve.msm import tree_reduce
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
G = host_ec.g1_generator()


def subgroup_points(seed: int, n: int):
    """n r-torsion points k_i*G, as affine ints and a port batch."""
    aff = subgroup_affine(seed, n)
    return aff, g1.from_affine_ints(aff, CPU)


def recorded_affine(key: str, *inputs) -> list:
    """Affine ints of a recorded JAX point batch."""
    return g1.to_affine_ints(ref_to_port(reference(key, *inputs)))


def test_generator_and_infinity():
    assert g1.to_affine_ints(g1.generator((2,), CPU)) == [G, G]
    assert g1.to_affine_ints(g1.infinity((1,), CPU)) == [None]
    assert torch.equal(g1.infinity((1,), CPU).x,
                       ref_to_port(jg1.infinity((1,))).x)


def test_add_double_edge_cases():
    """P+Q, P+P, P+(-P), P+O, O+Q, O+O (both infinity encodings) against
    the host oracle: the masked-select formulas are plain tensor code."""
    aff, pts = subgroup_points(1, 2)
    p_aff = [aff[0], aff[0], aff[0], aff[0], None, None]
    q_aff = [aff[1], aff[0], host_ec.g1_neg(aff[0]), None, aff[1], None]
    p = g1.from_affine_ints(p_aff, CPU)
    q = with_zero_infinity(g1.from_affine_ints(q_aff, CPU), 5)
    assert g1.to_affine_ints(g1.add(p, q)) == [
        host_ec.g1_add(a, b) for a, b in zip(p_aff, q_aff)]
    assert g1.to_affine_ints(g1.sub(p, q)) == [
        host_ec.g1_add(a, host_ec.g1_neg(b)) for a, b in zip(p_aff, q_aff)]
    assert g1.to_affine_ints(g1.double(p)) == [
        host_ec.g1_add(a, a) for a in p_aff]


def test_mul_matches_reference():
    """g1.mul (K3's plain version on the CPU) on port_helpers.mul_case:
    infinity in both encodings and the scalars 0, 1 and r-1."""
    aff, pts, ks = mul_case()
    got = g1.to_affine_ints(g1.mul(pts, fr.from_int(ks, CPU)))
    assert got == [host_ec.g1_mul(p, k) for p, k in zip(aff, ks)]
    assert got == recorded_affine("g1_mul", *convert.point_to_ref(pts),
                                  jfr.from_int(ks))


def test_scalar_mul_wrapper_takes_plain_on_cpu():
    aff, pts = subgroup_points(4, 3)
    digits = fr.scalar_windows_signed(fr.from_int([5, 6, 7], CPU))
    out = gk.g1_scalar_mul(pts, digits)
    assert torch.equal(out.x, gk.g1_scalar_mul_plain(pts, digits).x)
    assert gk.LAUNCHES == {"g1_scalar_mul": 0, "g1_glv_butterfly": 0,
                           "g1_add": 0, "g1_double": 0, "g1_window_table": 0,
                           "g1_fft_stage": 0, "g1_fixed_base_mul": 0,
                           "g1_sum": 0, "g1_horner": 0}
    meta = JacobianPoint(*(torch.empty_like(c, device="meta") for c in pts))
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_scalar_mul(meta, digits.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_glv_butterfly(meta, meta, digits.to("meta"), digits.to("meta"))


def test_glv_butterfly_plain_matches_oracle():
    """lo = A + k B and hi = A - k B for k = k1 + lambda k2 from the host
    GLV split, including A = infinity (the inverse FFT's 1/n step)."""
    aff, pts = subgroup_points(5, 8)
    a_aff, b_aff = aff[:4], aff[4:]
    a_aff[1] = None
    a = g1.from_affine_ints(a_aff, CPU)
    b = g1.from_affine_ints(b_aff, CPU)
    ks = random_ints(np.random.default_rng(6), 4, R)
    ks[2] = 0
    d1, d2 = (torch.from_numpy(d) for d in glv.twiddle_digits(ks))
    lo, hi = gk.g1_glv_butterfly(a, b, d1, d2)
    tk = [host_ec.g1_mul(q, k) for q, k in zip(b_aff, ks)]
    assert g1.to_affine_ints(lo) == [host_ec.g1_add(p, t)
                                     for p, t in zip(a_aff, tk)]
    assert g1.to_affine_ints(hi) == [host_ec.g1_add(p, host_ec.g1_neg(t))
                                     for p, t in zip(a_aff, tk)]


def test_glv_split_matches_reference():
    ks = random_ints(np.random.default_rng(7), 16, R) + [0, 1, R - 1]
    assert glv.GLV_LAMBDA == jglv.GLV_LAMBDA
    for k in ks:
        assert glv.decompose(k) == jglv.decompose(k)
        k1, k2 = glv.decompose(k)
        assert (k1 + glv.GLV_LAMBDA * k2) % R == k
        assert glv.signed_digits(k1) == jglv.signed_digits(k1)
    d1, d2 = glv.twiddle_digits(ks)
    r1, r2 = jglv.twiddle_digits(ks)
    assert np.array_equal(d1, r1) and np.array_equal(d2, r2)
    assert d1.min() >= -7 and d1.max() <= 8


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_g1_matches_reference(inverse):
    _, pts = fft_g1_case()
    got = fft_g1(FFTSettings(5, CPU), pts, inverse)
    assert g1.to_affine_ints(got) == recorded_affine(
        f"fft_g1:{int(inverse)}", *convert.point_to_ref(pts))


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_g1_matches_oracle(n, inverse):
    """out_i = sum_j w^(+-ij) P_j (/ n): with P_j = k_j G this is one host
    scalar multiply per output."""
    ks = random_ints(np.random.default_rng(40 + n), n, R)
    pts = g1.from_affine_ints([host_ec.g1_mul(G, k) for k in ks], CPU)
    got = fft_g1(FFTSettings(4, CPU), pts, inverse)
    w = pow(7, (R - 1) // n, R)
    if inverse:
        w = pow(w, -1, R)
    scale = pow(n, -1, R) if inverse else 1
    want = [host_ec.g1_mul(G, scale * sum(k * pow(w, i * j, R)
                                          for j, k in enumerate(ks)) % R)
            for i in range(n)]
    assert g1.to_affine_ints(got) == want


def test_fft_g1_batched_roundtrip():
    """Leading batch axes transform together (the batched part 1)."""
    aff, pts = subgroup_points(20, 8)
    fs = FFTSettings(4, CPU)
    batch = JacobianPoint(*(c.reshape(2, 4, 12) for c in pts))
    out = fft_g1(fs, batch)
    row1 = fft_g1(fs, JacobianPoint(*(c[4:] for c in pts)))
    assert g1.to_affine_ints(JacobianPoint(*(c[1] for c in out))) == \
        g1.to_affine_ints(row1)
    back = fft_g1(fs, out, inverse=True)
    flat = JacobianPoint(*(c.reshape(8, 12) for c in back))
    assert g1.to_affine_ints(flat) == aff


def column_sums(aff, rows):
    want = [None, None]
    for i, p in enumerate(aff[: 2 * rows]):
        want[i % 2] = host_ec.g1_add(want[i % 2], p)
    return want


@pytest.mark.parametrize("rows", [1, 2, 5, 8])
def test_tree_reduce_matches_oracle(rows):
    aff, pts = subgroup_points(30 + rows, rows * 2)
    aff[1] = None
    pts = g1.from_affine_ints(aff, CPU)
    batch = JacobianPoint(*(c.reshape(rows, 2, 12) for c in pts))
    assert g1.to_affine_ints(tree_reduce(g1.ops, batch)) == \
        column_sums(aff, rows)


def test_tree_reduce_matches_reference():
    """An odd row count: the port pads a level with infinity, the JAX
    package folds narrow batches with a scan; the sums agree."""
    aff, batch = tree_reduce_case()
    got = g1.to_affine_ints(tree_reduce(g1.ops, batch))
    assert got == column_sums(aff, 3)
    assert got == recorded_affine("tree_reduce",
                                  *convert.point_to_ref(batch))


def _proj_add_sequential(pl, p, q):
    """RCB15 Algorithm 7 (a = 0) one product at a time."""
    M = pl.M
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = M(x1, x2)
    t1 = M(y1, y2)
    t2 = M(z1, z2)
    t3 = M(x1 + y1, x2 + y2) - (t0 + t1)
    t4 = M(y1 + z1, y2 + z2) - (t1 + t2)
    y3 = M(x1 + z1, x2 + z2) - (t0 + t2)
    t0 = 3 * t0
    t2 = 12 * t2
    z3 = t1 + t2
    t1 = t1 - t2
    y3 = 12 * y3
    x3 = M(t3, t1) - M(t4, y3)
    y3 = M(t1, z3) + M(y3, t0)
    z3 = M(z3, t4) + M(t0, t3)
    return x3, y3, z3


def _proj_double_sequential(pl, p):
    """RCB15 Algorithm 9 (a = 0) one product at a time."""
    M = pl.M
    x, y, z = p
    t0 = M(y, y)
    z3 = 8 * t0
    t1 = M(y, z)
    t2 = 12 * M(z, z)
    x3 = M(t2, z3)
    y3 = t0 + t2
    z3 = M(t1, z3)
    t0 = t0 - 3 * t2
    y3 = x3 + M(t0, y3)
    x3 = 2 * M(t0, M(x, y))
    return x3, y3, z3


def test_plain_point_formulas_equal_one_product_at_a_time():
    """The plain engine's point formulas take their independent products
    in one call a tier; the limbs equal those of the formulas taken one
    product at a time, on lazy inputs (sums of ladder outputs), with a
    broadcast operand and the identity among the lanes."""
    pl = gk._plain(torch.device(CPU))
    _, pts = subgroup_points(7, 6)
    p = pl.jac_to_proj(pts)
    p = pl.proj_add(p, pl.proj_double(p))          # redundant limbs
    p = tuple(torch.cat((c, i)) for c, i in zip(p, pl.identity(p[0][:1])))
    q = tuple(c[2] for c in p)                      # (L,): broadcast
    for a, b in ((p, p), (p, q), (q, p)):
        got = pl.proj_add(a, b)
        want = _proj_add_sequential(pl, a, b)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert all(torch.equal(u, v) for u, v in
               zip(pl.proj_double(p), _proj_double_sequential(pl, p)))
