"""The port's G1 point kernels (their plain versions on the CPU), the
windowed MSM and the commitments, against the JAX package and the host
oracle. The JAX outputs are recorded (port_helpers.py): the fused
add/double Pallas kernels in interpret mode, `lin_comb_g1` and
`commit_to_poly` on the kzg_env CRS. Point kernel outputs are compared
word for word, MSM results in affine form."""

import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    FK20_COEFFS,
    TEST_SECRET,
    eval_poly,
    g1_add_case,
    msm_scalars,
    ref_to_port,
    reference,
    subgroup_affine,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve import kernels as gk
from kzg_tpu_torch.curve.msm import lin_comb_g1, sum_g1, tree_reduce
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.kzg.settings import KZGSettings
from kzg_tpu_torch.kzg.setup import secret_powers
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.ntt.fft_fr import fft
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
G = host_ec.g1_generator()


def same_words(p: JacobianPoint, ref) -> bool:
    return all(torch.equal(a, b) for a, b in zip(p, ref_to_port(ref)))


def crs() -> JacobianPoint:
    return ref_to_port(reference("crs", TEST_SECRET, CRS_SIZE))


def commitment_oracle(coeffs) -> tuple:
    """[p(s)]G for the known secret."""
    return host_ec.g1_mul(G, eval_poly(coeffs, TEST_SECRET % R, R))


@pytest.mark.parametrize("order", ["pq", "qp"])
def test_g1_add_matches_pallas_kernel(order):
    """P+P, P+(-P), P+Q, P+inf, inf+Q (both infinity encodings), inf+inf:
    the same words as _add_fn, and the oracle's sums."""
    p_aff, q_aff, p, q = g1_add_case()
    inputs = convert.point_to_ref(p) + convert.point_to_ref(q)
    if order == "qp":
        p_aff, q_aff, p, q = q_aff, p_aff, q, p
    out = gk.g1_add(p, q)
    assert same_words(out, reference(f"g1_add:{order}", *inputs))
    assert g1.to_affine_ints(out) == [host_ec.g1_add(x, y)
                                      for x, y in zip(p_aff, q_aff)]
    # P + (-P) leaves as all-zero words, as the Pallas kernel makes it
    assert int(out.x[1].abs().sum() + out.y[1].abs().sum()) == 0


def test_g1_double_matches_pallas_kernel():
    p_aff, _, p, _ = g1_add_case()
    out = gk.g1_double(p)
    assert same_words(out, reference("g1_double", *convert.point_to_ref(p)))
    assert g1.to_affine_ints(out) == [host_ec.g1_add(x, x) for x in p_aff]


def test_point_wrappers_take_plain_on_cpu():
    _, _, p, q = g1_add_case()
    for got, want in ((gk.g1_add(p, q), gk.g1_add_plain(p, q)),
                      (gk.g1_double(p), gk.g1_double_plain(p))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = JacobianPoint(*(c[2:3] for c in q))      # broadcasts over p
    wide = JacobianPoint(*(c.expand_as(d) for c, d in zip(one, p)))
    assert all(torch.equal(a, b) for a, b in
               zip(gk.g1_add(p, one), gk.g1_add(p, wide)))
    assert set(gk.LAUNCHES.values()) == {0}
    meta = JacobianPoint(*(torch.empty_like(c, device="meta") for c in p))
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_add(meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_double(meta)


def test_kernel_ops_facade():
    """ops_kernel's sub, neg, select and infinity against the oracle."""
    aff = subgroup_affine(61, 4)
    p = g1.from_affine_ints(aff[:2], CPU)
    q = g1.from_affine_ints(aff[2:], CPU)
    ops = g1.ops_kernel
    assert g1.to_affine_ints(ops.sub(p, q)) == [
        host_ec.g1_add(a, host_ec.g1_neg(b)) for a, b in zip(aff, aff[2:])]
    inf = ops.infinity_like(p)
    assert bool(ops.is_infinity(inf).all())
    assert not bool(ops.is_infinity(p).any())
    mask = torch.tensor([True, False])
    assert g1.to_affine_ints(ops.select(mask, inf, ops.neg(q))) == \
        [None, host_ec.g1_neg(aff[3])]


def test_sum_g1_matches_oracle():
    """An odd point count, with an infinity lane, on the kernel ops."""
    aff = subgroup_affine(62, 5)
    aff[3] = None
    want = None
    for a in aff:
        want = host_ec.g1_add(want, a)
    got = sum_g1(g1.from_affine_ints(aff, CPU))
    assert g1.to_affine_ints(JacobianPoint(*(c[None] for c in got))) == \
        [want]
    batch = g1.from_affine_ints(aff[:4], CPU)
    two = tree_reduce(g1.ops_kernel,
                      JacobianPoint(*(c.reshape(2, 2, 12) for c in batch)))
    assert g1.to_affine_ints(two) == [host_ec.g1_add(aff[0], aff[2]),
                                      host_ec.g1_add(aff[1], aff[3])]


def test_lin_comb_g1_matches_reference():
    """Two MSMs over the 17-point CRS (a leading scalar-batch axis), with
    the scalars 0, 1 and r-1 among them."""
    scalars = msm_scalars()
    sc = fr.from_int(scalars, CPU)
    got = g1.to_affine_ints(lin_comb_g1(crs(), sc))
    want = reference("lin_comb_g1", TEST_SECRET, CRS_SIZE,
                     jfr.from_int(scalars))
    assert got == g1.to_affine_ints(ref_to_port(want))
    powers = secret_powers(TEST_SECRET, CRS_SIZE)
    assert got == [host_ec.g1_mul(G, sum(k * s for k, s in zip(row, powers))
                                  % R) for row in scalars]


def test_commit_to_poly_matches_reference():
    ks = KZGSettings(FFTSettings(5, CPU), crs())
    got = ks.commit_to_poly(fr.from_int(FK20_COEFFS, CPU))
    got = g1.to_affine_ints(JacobianPoint(*(c[None] for c in got)))
    want = reference("commit_to_poly", TEST_SECRET, CRS_SIZE,
                     jfr.from_int(FK20_COEFFS))
    assert got == g1.to_affine_ints(
        JacobianPoint(*(c[None] for c in ref_to_port(want))))
    assert got == [commitment_oracle(FK20_COEFFS)]


def test_commit_to_eval_poly_matches_oracle():
    """Evaluations on the 4-point subdomain -> inverse FFT -> commit."""
    coeffs = [5, 0, R - 1, 12345]
    fs = FFTSettings(5, CPU)
    evals = fft(fs, fr.from_int(coeffs, CPU))
    ks = KZGSettings(fs, crs())
    got = ks.commit_to_eval_poly(evals)
    assert g1.to_affine_ints(JacobianPoint(*(c[None] for c in got))) == \
        [commitment_oracle(coeffs)]
    with pytest.raises(ValueError):
        ks.commit_to_poly(fr.zeros((CRS_SIZE + 1,), CPU))
