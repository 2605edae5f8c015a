"""The G1 FFT's radix plans (curve/fft_g1.py): dense stages on
`g1_fft_stage`, radix-2 stages on `g1_glv_butterfly`, and mixed plans,
forward, inverse and batched, against the JAX package's recorded
`fft_g1:*` outputs and the host oracle, in affine form. On the CPU every
stage runs the kernels' plain versions; the plan's host tables (digit
reversal, twiddle digit rows) are checked on their own."""

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    fft_g1_case,
    random_ints,
    reference,
    ref_to_port,
)

from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import fft_g1 as F
from kzg_tpu_torch.curve import g1, glv
from kzg_tpu_torch.curve import kernels as gk
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.domain import FFTSettings, _expanded_roots_int
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
G = host_ec.g1_generator()


def dft_oracle(ks, inverse: bool) -> list:
    """out_i = sum_j w^(+-ij) k_j G (/ n) for points k_j G."""
    n = len(ks)
    w = pow(7, (R - 1) // n, R)
    if inverse:
        w = pow(w, -1, R)
    scale = pow(n, -1, R) if inverse else 1
    return [host_ec.g1_mul(G, scale * sum(k * pow(w, i * j, R)
                                          for j, k in enumerate(ks)) % R)
            for i in range(n)]


@pytest.mark.parametrize("plan,inverse", [((2, 4), False), ((4, 2), True),
                                          ((2, 2, 2), True)])
def test_plans_match_reference(plan, inverse):
    """The recorded 8-point transform on the width-32 domain (the part-1
    shape of the l = 2 FK20 settings) under mixed and radix-2 plans."""
    _, pts = fft_g1_case()
    got = F._fft_g1_core(pts, 5, inverse, plan)
    want = ref_to_port(reference(f"fft_g1:{int(inverse)}",
                                 *convert.point_to_ref(pts)))
    assert g1.to_affine_ints(got) == g1.to_affine_ints(want)


@pytest.mark.parametrize("n,plan,inverse", [
    (2, (2,), True),            # one butterfly, then the 1/n butterfly
    (4, (2, 2), False),
    (16, (4, 4), True),         # 1/n folded into the second stage
    (16, (2, 8), False),        # a butterfly, then a wide stage
])
def test_plans_match_oracle(n, plan, inverse):
    ks = random_ints(np.random.default_rng(80 + n), n, R)
    pts = g1.from_affine_ints([host_ec.g1_mul(G, k) for k in ks], CPU)
    got = F._fft_g1_core(pts, 4, inverse, plan)
    assert g1.to_affine_ints(got) == dft_oracle(ks, inverse)


@pytest.mark.parametrize("plan,inverse", [((4,), False), ((4,), True),
                                          ((2, 2), False), ((2, 2), True)])
def test_plans_at_infinity(plan, inverse):
    """Points a, b, c, d with a + b + c + d = 0: output 0 is the point at
    infinity, reached by adding a point to its negation, and its Jacobian
    words are all zero on every plan (the plain projective-to-Jacobian
    step reduces Z fully, to 0 and not m)."""
    for seed in (81, 92):
        ks = random_ints(np.random.default_rng(seed), 3, R)
        ks.append(-sum(ks) % R)
        pts = g1.from_affine_ints([host_ec.g1_mul(G, k) for k in ks], CPU)
        got = F._fft_g1_core(pts, 4, inverse, plan)
        assert g1.to_affine_ints(got) == dft_oracle(ks, inverse)
        assert all(not c[0].any() for c in got)


def test_batched_mixed_plan_roundtrip():
    """(2, 4) points through a (2, 2) plan: each row is its own
    transform, and the inverse under the dense plan brings them back."""
    ks = random_ints(np.random.default_rng(90), 8, R)
    aff = [host_ec.g1_mul(G, k) for k in ks]
    pts = g1.from_affine_ints(aff, CPU)
    batch = JacobianPoint(*(c.reshape(2, 4, 12) for c in pts))
    fs = FFTSettings(4, CPU)
    out = F._fft_g1_core(batch, fs.max_scale, False, (2, 2))
    row1 = JacobianPoint(*(c[1] for c in out))
    assert g1.to_affine_ints(row1) == dft_oracle(ks[4:], False)
    back = F.fft_g1(fs, out, inverse=True)
    flat = JacobianPoint(*(c.reshape(8, 12) for c in back))
    assert g1.to_affine_ints(flat) == aff


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def test_plan_helpers():
    assert F.default_plan(2) == (2,)
    assert F.default_plan(128) == (128,)
    assert int(np.prod(F.default_plan(8192))) == 8192
    assert F.mixed_plan(8192, 8) == (2, 8, 8, 8, 8)
    assert F.mixed_plan(8192, 128) == (64, 128)
    assert F.mixed_plan(64, 4) == (4, 4, 4)
    assert F.digit_reversal((2,) * 5).tolist() == \
        [bitrev(i, 5) for i in range(32)]
    assert F.digit_reversal((8,)).tolist() == list(range(8))
    # (2, 4): the last radix is the fastest digit of the input index
    assert F.digit_reversal((2, 4)).tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    fs = FFTSettings(10, CPU)
    for bad in ((3, 4), (4,), (1, 8), (2, 256, 2)):
        n = 1024 if 256 in bad else 8
        with pytest.raises(ValueError, match="plan"):
            F._fft_g1_core(g1.infinity((n,), CPU), fs.max_scale,
                            False, bad)


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_tables(inverse):
    """Each wide stage's digit rows are the GLV split of
    w_m^(j (q + m' k)), times 1/n on the inverse's last wide stage, and
    its src and dst put group (b, q)'s input j and output k at
    b m + q + m' j (k), read through the digit reversal at stage 1."""
    plan, n, scale = (4, 2, 4), 32, 6
    stages, perm, scale_digits = F._plan_host(scale, n, inverse, plan)
    roots = _expanded_roots_int(scale)
    if inverse:
        roots = tuple(reversed(roots))
    rev = F.digit_reversal(plan)
    assert perm is None and scale_digits is None
    assert [s[0] for s in stages] == ["wide", "bf", "wide"]
    m = 1
    for t, (stage, r) in enumerate(zip(stages, plan)):
        mp, m = m, m * r
        if stage[0] == "bf":
            d1, d2 = glv.twiddle_digits(
                [roots[q * (64 // m)] for q in range(mp)] * (n // m))
            assert np.array_equal(stage[1], d1)
            assert np.array_equal(stage[2], d2)
            continue
        _, r_, src, dst, digits = stage
        assert r_ == r and digits.shape == (mp, r, r, 2, 33)
        fold = pow(n, -1, R) if inverse and t == 2 else 1
        for q, k, j in ((0, 0, 0), (mp - 1, r - 1, r - 1), (mp // 2, 1, 2)):
            s = roots[(j * (q + mp * k)) % m * (64 // m)] * fold % R
            d1, d2 = glv.twiddle_digits([s])
            assert np.array_equal(digits[q, k, j, 0], d1[0])
            assert np.array_equal(digits[q, k, j, 1], d2[0])
        b, q = n // m - 1, mp - 1
        gl = b * mp + q
        for i in range(r):
            at = b * m + q + mp * i
            assert dst[gl * r + i] == at
            assert src[gl * r + i] == (rev[at] if t == 0 else at)


def test_stage_wrappers_take_plain_on_cpu():
    """On the CPU the stage and table wrappers are their plain versions;
    any other device than CUDA is refused."""
    ks = [3, 5, 7, 11]
    pts = g1.from_affine_ints([host_ec.g1_mul(G, k) for k in ks], CPU)
    gk.reset_launches()
    tables = gk.g1_window_table(pts, 1)
    assert torch.equal(tables, gk.g1_window_table_plain(pts, 1))
    stages, _, _ = F._plan_device(2, 4, False, (4,), torch.device(CPU))
    _, r, src, dst, digits = stages[0]
    out = gk.g1_fft_stage(gk.g1_window_table(pts, 1, src, 4), digits, dst,
                          4, r)
    assert g1.to_affine_ints(out) == dft_oracle(ks, False)
    assert set(gk.LAUNCHES.values()) == {0}
    meta = JacobianPoint(*(torch.empty_like(c, device="meta") for c in pts))
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_window_table(meta, 1)
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_fft_stage(tables.to("meta"), digits.to("meta"),
                        dst.to("meta"), 4, 4)
