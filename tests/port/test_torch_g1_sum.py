"""The one-launch row sums of the port (their plain versions on the CPU):
`g1_sum` against the host oracle on edge rows and against the recorded
`kzg_tpu` tree sum; batches of commitments on the CRS's fixed-base
tables (`KZGSettings.commit_to_poly` -> `g1_fixed_base_mul` -> `g1_sum`)
against the recorded `lin_comb_g1` and the host oracle; and
`g1_horner` against the Horner loop of 4 doublings and 1 add a window on
the plain engine `g1.ops`. Sums are compared in affine form, infinity
also as its all-zero words."""

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    TEST_SECRET,
    eval_poly,
    msm_scalars,
    random_ints,
    ref_to_port,
    reference,
    subgroup_affine,
    tree_reduce_case,
    with_zero_infinity,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve import kernels as gk
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.kzg.settings import KZGSettings
from kzg_tpu_torch.kzg.setup import secret_powers
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
G = host_ec.g1_generator()


def affine(p: JacobianPoint) -> list:
    return g1.to_affine_ints(JacobianPoint(*(c.reshape(-1, 12) for c in p)))


def host_sum(points) -> tuple:
    acc = None
    for a in points:
        acc = host_ec.g1_add(acc, a)
    return acc


@pytest.fixture(scope="module")
def ks() -> KZGSettings:
    """The kzg_env CRS with its fixed-base tables, built once."""
    settings = KZGSettings(FFTSettings(5, CPU),
                           ref_to_port(reference("crs", TEST_SECRET,
                                                 CRS_SIZE)))
    settings.secret_g1_tables
    return settings


def edge_row(case: str):
    """(affine points, port points) of one row; infinity as (1, 1, 0),
    and in the "odd" and "infinity" rows one lane as all-zero words."""
    a = subgroup_affine(140, 13)
    aff = {"one": a[:1],
           "odd": a[:5] + [None] + a[6:12] + [None],
           "infinity": [None] * 4,
           "p_minus_p": [a[0], host_ec.g1_neg(a[0])],
           "p_plus_p": [a[1], a[1]]}[case]
    pts = g1.from_affine_ints(aff, CPU)
    zero_lane = {"odd": 12, "infinity": 1}.get(case)
    if zero_lane is not None:
        pts = with_zero_infinity(pts, zero_lane)
    return aff, pts


@pytest.mark.parametrize("case", ["one", "odd", "infinity", "p_minus_p",
                                  "p_plus_p"])
def test_g1_sum_edge_rows(case):
    """N = 1, an odd N with infinity inside, a row all at infinity in
    both encodings, P with -P and P with P: the sum equals the oracle's,
    and infinity leaves as all-zero words."""
    aff, pts = edge_row(case)
    gk.reset_launches()
    row = JacobianPoint(*(c[None] for c in pts))
    got = gk.g1_sum(row)
    assert got.x.shape == (1, 12)
    want = host_sum(aff)
    assert affine(got) == [want]
    if want is None:
        assert not any(bool(c.any()) for c in got)
    assert all(torch.equal(a, b) for a, b in zip(got, gk.g1_sum_plain(row)))
    assert set(gk.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 64, 127, 128])
def test_g1_sum_plain_short_rows_equal_the_full_block(n):
    """The plain sum's shortcut for a row of at most one warp's items
    (32 x SUM_RUN) gives the partials of the whole block, every thread
    and the lanes past n included, with infinity in both encodings among
    the items."""
    assert n <= 32 * gk.SUM_RUN
    aff = [host_ec.g1_mul(G, 7 * k + n) for k in range(2 * n)]
    aff[n // 2] = aff[n + n // 3] = None
    pts = with_zero_infinity(g1.from_affine_ints(aff, CPU), n + n // 3)
    rows = JacobianPoint(*(c.reshape(2, n, 12) for c in pts))
    got = gk._sum_pass_plain(rows)
    want = gk._sum_pass_plain(rows, warp_rows=False)
    assert got.x.shape == want.x.shape == (2, 1, 12)
    assert affine(got) == affine(want) == [
        host_sum(aff[k * n:(k + 1) * n]) for k in range(2)]


def test_g1_sum_matches_tree_reduce_record():
    """The recorded kzg_tpu tree sum of a (3, 2) batch along axis 0."""
    aff, batch = tree_reduce_case()
    got = gk.g1_sum(batch, dim=0)
    rec = ref_to_port(reference("tree_reduce",
                                *convert.point_to_ref(batch)))
    assert affine(got) == g1.to_affine_ints(rec)
    assert affine(got) == [host_sum(aff[0::2]), host_sum(aff[1::2])]


def test_g1_sum_wide_rows_and_axes():
    """A row wider than one block (SUM_RUN x SUM_THREADS points) takes a
    second pass over the block partials; a middle axis sums like the
    rows of its transpose."""
    n = gk.SUM_RUN * gk.SUM_THREADS + 3
    ks_ = list(range(1, n + 1))
    pts = g1.from_affine_ints([host_ec.g1_mul(G, k) for k in ks_], CPU)
    got = gk.g1_sum(JacobianPoint(*(c.reshape(1, n, 12) for c in pts)))
    assert affine(got) == [host_ec.g1_mul(G, n * (n + 1) // 2)]
    aff = subgroup_affine(141, 12)
    cube = JacobianPoint(*(c.reshape(2, 3, 2, 12)
                           for c in g1.from_affine_ints(aff, CPU)))
    got = gk.g1_sum(cube, dim=1)
    assert got.x.shape == (2, 2, 12)
    assert affine(got) == [host_sum(aff[a * 6 + b::2][:3])
                           for a in range(2) for b in range(2)]
    with pytest.raises(ValueError):
        gk.g1_sum(JacobianPoint(*(c[:0] for c in pts)))


def test_commit_matches_lin_comb_record(ks):
    """A (2, 17) batch of commitments on the (17, 64, 8, 36) CRS tables
    (scalars 0, 1 and r-1 among them) equals the recorded variable-base
    lin_comb_g1 and the oracle. (test_torch_msm.py holds a single
    commitment to the recorded commit_to_poly.)"""
    assert ks.secret_g1_tables.shape == (CRS_SIZE, 64, 8, 36)
    scalars = msm_scalars()
    got = affine(ks.commit_to_poly(fr.from_int(scalars, CPU)))
    want = reference("lin_comb_g1", TEST_SECRET, CRS_SIZE,
                     jfr.from_int(scalars))
    assert got == g1.to_affine_ints(ref_to_port(want))
    powers = secret_powers(TEST_SECRET, CRS_SIZE)
    assert got == [host_ec.g1_mul(G, sum(k * s for k, s in zip(row, powers))
                                  % R) for row in scalars]


def test_batched_commit_uses_first_bases(ks):
    """n = 9 below the CRS size commits on the first 9 bases; a (2, 9)
    batch equals the two single commitments word for word."""
    rng = np.random.default_rng(142)
    rows = [random_ints(rng, 9, R) for _ in range(2)]
    batch = ks.commit_to_poly(fr.from_int(rows, CPU))
    for i, row in enumerate(rows):
        one = ks.commit_to_poly(fr.from_int(row, CPU))
        assert all(torch.equal(a[i], b) for a, b in zip(batch, one))
        assert affine(one) == [host_ec.g1_mul(G, eval_poly(
            row, TEST_SECRET % R, R))]


@pytest.mark.parametrize("b", [1, 2])
def test_horner_plain_matches_ops_loop(b):
    """acc = sum_j 16^j S_j over 64 window sums (some at infinity, one in
    all-zero words): g1_horner equals the Horner loop on g1.ops in affine
    form."""
    aff = subgroup_affine(143 + b, 64 * b)
    aff[0] = aff[63] = None
    w = g1.from_affine_ints(aff, CPU)
    w = with_zero_infinity(w, 0)
    w = JacobianPoint(*(c.reshape(b, 64, 12) for c in w))
    got = gk.g1_horner(w)
    assert got.x.shape == (b, 12)
    acc = JacobianPoint(*(c[:, 63] for c in w))
    for j in range(62, -1, -1):
        for _ in range(4):
            acc = g1.double(acc)
        acc = g1.add(acc, JacobianPoint(*(c[:, j] for c in w)))
    assert affine(got) == g1.to_affine_ints(acc)
    assert all(torch.equal(x, y) for x, y in zip(got, gk.g1_horner_plain(w)))


def test_sum_wrappers_raise_off_cpu():
    """On a tensor that is not on the CPU the wrappers launch or raise;
    they never take the plain version."""
    meta = JacobianPoint(*(torch.empty((2, 64, 12), dtype=torch.int32,
                                       device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_sum(meta)
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_horner(meta)
