"""Fr/Fp arithmetic of the port against the JAX package, and the kernel
wrappers of field/kernels.py (K1 mont_mul, fr_scale, K2, butterfly, the
recoding fr_signed_windows of Montgomery words) on the CPU. The
interpreted _butterfly_fn and the JAX batch inversion, slow to compile,
are recorded (port_helpers.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    batch_inv_input,
    butterfly_input,
    edge_ints,
    random_ints,
    reference,
)

from kzg_tpu.field import fp as jfp
from kzg_tpu.field import fr as jfr
from kzg_tpu.field import limbs as jlimbs
from kzg_tpu_torch import convert
from kzg_tpu_torch.field import fp, fr, kernels, limbs

FIELDS = {"Fr": (jfr, fr), "Fp": (jfp, fp)}
N_RANDOM = 53


def operands(name: str, seed: int):
    """(a, b) as port words and JAX arrays: random values plus every pair
    of edge values (a, b near m on both sides)."""
    jmod, mod = FIELDS[name]
    m = mod.SPEC.modulus
    rng = np.random.default_rng(seed)
    edges = edge_ints(m)
    av = random_ints(rng, N_RANDOM, m) + [x for x in edges for _ in edges]
    bv = random_ints(rng, N_RANDOM, m) + [y for _ in edges for y in edges]
    a_ref, b_ref = jmod.from_int(av), jmod.from_int(bv)
    a, b = mod.from_int(av, CPU), mod.from_int(bv, CPU)
    # the same integers: the words are a repack of the JAX limbs
    assert torch.equal(a, convert.words_from_ref(a_ref, CPU))
    return (a, b), (jnp.asarray(a_ref), jnp.asarray(b_ref)), (av, bv)


@pytest.mark.parametrize("name", ["Fr", "Fp"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_op_matches_reference(name, op):
    jmod, mod = FIELDS[name]
    (a, b), (ja, jb), (av, bv) = operands(name, seed=len(op))
    got = getattr(mod, op)(a, b)
    want = np.asarray(getattr(jmod, op)(ja, jb))
    assert torch.equal(got, convert.words_from_ref(want, CPU))
    m = mod.SPEC.modulus
    py = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    assert list(mod.to_int(got)) == [py(x, y) % m for x, y in zip(av, bv)]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_neg_and_from_mont_match_reference(name):
    jmod, mod = FIELDS[name]
    (a, _), (ja, _), (av, _) = operands(name, seed=7)
    assert torch.equal(mod.neg(a),
                       convert.words_from_ref(np.asarray(jmod.neg(ja)), CPU))
    if name == "Fr":
        got = fr.from_mont(a)
        want = np.asarray(jlimbs.from_mont(jfr.SPEC, ja))
        assert torch.equal(got, convert.words_from_ref(want, CPU))
        assert fr.SPEC.words(av, CPU).equal(got)


def test_fp_inv_sqr_match_reference():
    (a, _), (ja, _), _ = operands("Fp", seed=11)
    a, ja = a[:8], ja[:8]
    assert torch.equal(fp.sqr(a),
                       convert.words_from_ref(np.asarray(jfp.sqr(ja)), CPU))
    assert torch.equal(fp.inv(a),
                       convert.words_from_ref(np.asarray(jfp.inv(ja)), CPU))


def test_signed_windows_edge_scalars():
    """The recoding of Montgomery words at the ends of Fr's range: the
    digits rebuild the scalar, and each lies in its window's range."""
    r = fr.SPEC.modulus
    vals = [0, 1, 7, 8, 9, r - 1, r - 2, (1 << 252) - 1, 0x888 * 16 ** 60,
            int("8" * 63, 16) % r]
    got = kernels.fr_signed_windows(fr.from_int(vals, CPU))
    for v, row in zip(vals, got.tolist()):
        assert sum(d << (4 * j) for j, d in enumerate(row)) == v
        assert all(-8 <= d <= 7 for d in row[:63]) and 0 <= row[63] <= 8


def test_signed_windows_mont_edge_scalars_match_reference():
    """The plain recoding of Montgomery words (the kernel reduces them in
    the same launch) on the edge scalars above, against the live kzg_tpu
    recoding; the digits rebuild the scalar."""
    r = fr.SPEC.modulus
    vals = [0, 1, 7, 8, 9, r - 1, r - 2, (1 << 252) - 1, 0x888 * 16 ** 60,
            int("8" * 63, 16) % r]
    mont = fr.from_int(vals, CPU)
    got = kernels.fr_signed_windows_plain(mont)
    want = np.asarray(jfr.scalar_windows_signed(jfr.from_int(vals)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(kernels.fr_signed_windows(mont), got)
    for v, row in zip(vals, got.tolist()):
        assert sum(d << (4 * j) for j, d in enumerate(row)) == v


def test_scalar_windows_signed_is_one_recoding():
    """fr.scalar_windows_signed is fr_signed_windows on the Montgomery
    words (one launch on the card), batch dims kept; the digits rebuild
    the scalars."""
    (a, _), _, (av, _) = operands("Fr", seed=6)
    a = a[:24].reshape(2, 12, 8)
    got = fr.scalar_windows_signed(a)
    assert torch.equal(got, kernels.fr_signed_windows(a))
    assert got.shape == (2, 12, 64)
    for v, row in zip(av[:24], got.reshape(24, 64).tolist()):
        assert sum(d << (4 * j) for j, d in enumerate(row)) == v


def test_scalar_windows_signed_matches_reference():
    (a, _), (ja, _), (av, _) = operands("Fr", seed=5)
    got = fr.scalar_windows_signed(a)
    want = np.asarray(jfr.scalar_windows_signed(ja))
    assert np.array_equal(got.numpy(), want)
    assert got.shape[-1] == 64
    assert int(got[..., :63].min()) >= -8 and int(got[..., :63].max()) <= 7
    assert int(got[..., 63].min()) >= 0 and int(got[..., 63].max()) <= 8
    for row, v in zip(got.tolist(), av):
        assert sum(d << (4 * j) for j, d in enumerate(row)) == v


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_spec_constants(name):
    """R and the CIOS digit constant n0 = -m^-1 mod 2^32 of the kernels."""
    jmod, mod = FIELDS[name]
    spec = mod.SPEC
    assert spec.r == 1 << (16 * jmod.SPEC.n_limbs)
    assert spec.modulus == jmod.SPEC.modulus
    assert (spec.modulus * spec.n0) % (1 << 32) == (1 << 32) - 1
    assert (spec.modulus * spec.nprime) % spec.r == spec.r - 1
    assert spec.decode(spec.encode([[3, 4], [5, 6]], CPU)).tolist() == \
        [[3, 4], [5, 6]]


def test_mont_mul_broadcast_and_fr_scale():
    rng = np.random.default_rng(3)
    r = fr.SPEC.modulus
    xv = random_ints(rng, 12, r)
    x = fr.from_int(xv, CPU).reshape(3, 4, 8)
    c = fr.from_int(pow(16, -1, r), CPU)
    want = [v * pow(16, -1, r) % r for v in xv]
    assert fr.to_int(kernels.fr_scale(fr.SPEC, x, c)).reshape(-1).tolist() \
        == want
    assert fr.to_int(kernels.mont_mul(fr.SPEC, x, c)).reshape(-1).tolist() \
        == want


def test_butterfly_stage_plain_matches_ints():
    """One DIT stage: hi = a + b*tw, lo = a - b*tw, tw = roots[j*stride]."""
    rng = np.random.default_rng(4)
    r = fr.SPEC.modulus
    from kzg_tpu_torch.ntt.domain import FFTSettings

    fs = FFTSettings(4, CPU)
    roots = fs.roots_of_unity_int()
    xv = random_ints(rng, 2 * 16, r)
    x = fr.from_int(xv, CPU).reshape(2, 16, 8)
    log_half, stride = 2, 2
    out = kernels.fr_butterfly_stage(
        fr.SPEC, x.clone(), fs.expanded_roots_of_unity, log_half, stride)
    got = fr.to_int(out).tolist()
    half = 1 << log_half
    for row in range(2):
        v = xv[16 * row: 16 * row + 16]
        for g in range(0, 16, 2 * half):
            for j in range(half):
                a, b = v[g + j], v[g + j + half] * roots[j * stride] % r
                assert got[row][g + j] == (a + b) % r
                assert got[row][g + j + half] == (a - b) % r


def test_wrappers_refuse_non_cpu_tensors():
    """Off the CPU a wrapper launches its kernel or raises: it never runs
    the plain version. A meta tensor stands for a device tensor here."""
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mont_mul(fr.SPEC, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_scale(fr.SPEC, meta, meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_butterfly_stage(fr.SPEC, meta.reshape(1, 4, 8), meta, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_dif_stage(fr.SPEC, meta.reshape(1, 4, 8), meta, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.butterfly(fr.SPEC, meta, meta, meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_signed_windows(meta)
    for op in ("add", "sub"):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.fr_add_sub(fr.SPEC, op, meta, meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_add_sub(fr.SPEC, "neg", meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_pow(fr.SPEC, meta, 5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_batch_inv(fr.SPEC, meta)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_fft_block(fr.SPEC, meta.reshape(1, 4, 8), meta, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_das_block(fr.SPEC, meta.reshape(1, 4, 8), meta, meta, 16)
    idx = np.zeros((1, kernels.LEAF_FACTORS), dtype=np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_zero_poly_leaves(fr.SPEC, meta, idx, idx == 0)
    assert set(kernels.LAUNCHES.values()) == {0}
    assert set(kernels.LAUNCHES) == {
        "mont_mul", "fr_scale", "fr_butterfly_stage", "fr_dif_stage",
        "butterfly", "fr_signed_windows", "fr_add_sub", "fr_pow",
        "fr_batch_inv", "fr_fft_block", "fr_das_block",
        "fr_zero_poly_leaves"}


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_butterfly_matches_pallas_kernel(name):
    """(a + b tw, a - b tw) at the 200 lanes of
    tests/test_field_backends.py:78-89: the same words as _butterfly_fn
    in interpret mode (recorded), and the Python ints; then with one
    broadcast twiddle."""
    jmod, mod = FIELDS[name]
    m = mod.SPEC.modulus
    av, bv, tv = butterfly_input(m)
    a, b, tw = (mod.from_int(v, CPU) for v in (av, bv, tv))
    hi, lo = kernels.butterfly(mod.SPEC, a, b, tw)
    want = reference(f"butterfly:{name}", jmod.from_int([av, bv, tv]))
    assert torch.equal(torch.stack([hi, lo]),
                       convert.words_from_ref(want, CPU))
    assert list(mod.to_int(hi)) == [(x + y * t) % m
                                    for x, y, t in zip(av, bv, tv)]
    assert list(mod.to_int(lo)) == [(x - y * t) % m
                                    for x, y, t in zip(av, bv, tv)]
    hi1, lo1 = kernels.butterfly(mod.SPEC, a, b, tw[5])
    t = tv[5]
    assert list(mod.to_int(hi1)) == [(x + y * t) % m for x, y in zip(av, bv)]
    assert list(mod.to_int(lo1)) == [(x - y * t) % m for x, y in zip(av, bv)]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_butterfly_plain_with_tail_matches_ints(name):
    """The plain butterfly at 2^7 - 3 lanes, a count that is not a
    multiple of a block (the card's tail is held by chip_smoke.py), with
    the field's edge values, per-lane and broadcast twiddle, against
    Python ints."""
    _, mod = FIELDS[name]
    m = mod.SPEC.modulus
    rng = np.random.default_rng(17)
    n = (1 << 7) - 3
    edges = edge_ints(m)
    av, bv, tv = (random_ints(rng, n - len(edges), m) + edges[k:] + edges[:k]
                  for k in range(3))
    a, b, tw = (mod.from_int(v, CPU) for v in (av, bv, tv))
    for t, tws in ((tw, tv), (tw[-1], [tv[-1]] * n)):
        hi, lo = kernels.butterfly(mod.SPEC, a, b, t)
        assert hi.shape == lo.shape == (n, mod.SPEC.n_words)
        assert list(mod.to_int(hi)) == [(x + y * w) % m
                                        for x, y, w in zip(av, bv, tws)]
        assert list(mod.to_int(lo)) == [(x - y * w) % m
                                        for x, y, w in zip(av, bv, tws)]


@pytest.mark.parametrize("e", [0, 1, 2, 12345, fr.SPEC.modulus - 2])
def test_fr_pow_static_matches_reference(e):
    (a, _), (ja, _), (av, _) = operands("Fr", seed=13)
    a, ja, av = a[:16], ja[:16], av[:16]
    got = fr.pow_static(a, e)
    want = np.asarray(jfr.pow_static(ja, e))
    assert torch.equal(got, convert.words_from_ref(want, CPU))
    assert list(fr.to_int(got)) == [pow(x, e, fr.SPEC.modulus) for x in av]


def test_fr_inv_div_and_predicates_match_reference():
    """Fermat inv (0 -> 0) and div against the JAX package; eq, is_zero,
    is_one, select."""
    (a, b), (ja, jb), (av, bv) = operands("Fr", seed=14)
    a, b, ja, jb, av, bv = a[:20], b[:20], ja[:20], jb[:20], av[:20], bv[:20]
    r = fr.SPEC.modulus
    got = fr.inv(a)
    assert torch.equal(got, convert.words_from_ref(np.asarray(jfr.inv(ja)),
                                                   CPU))
    assert list(fr.to_int(got)) == [pow(x, -1, r) if x else 0 for x in av]
    assert list(fr.to_int(fr.div(a, b))) == \
        [x * pow(y, -1, r) % r if y else 0 for x, y in zip(av, bv)]
    assert fr.eq(a, a).all() and not fr.eq(a, fr.add(a, fr.from_int(1, CPU))
                                           ).any()
    assert fr.is_zero(a).tolist() == [x == 0 for x in av]
    assert fr.is_one(a).tolist() == [x == 1 for x in av]
    mask = torch.tensor([i % 2 == 0 for i in range(20)])
    assert list(fr.to_int(fr.select(mask, a, b))) == \
        [x if i % 2 == 0 else y for i, (x, y) in enumerate(zip(av, bv))]


def test_fr_batch_inv_masks_zero_lanes():
    """The Montgomery trick with zero lanes 3 and 9: they map to 0 and do
    not poison the rest, as in the JAX package (recorded) and Fermat."""
    vals = batch_inv_input()
    got = fr.batch_inv(fr.from_int(vals, CPU))
    want = reference("batch_inv", jfr.from_int(vals))
    assert torch.equal(got, convert.words_from_ref(want, CPU))
    r = fr.SPEC.modulus
    assert list(fr.to_int(got)) == [pow(v, -1, r) if v else 0 for v in vals]
    # a leading batch shape, and the one-element case (Fermat alone)
    two = fr.batch_inv(fr.from_int(vals[:12], CPU).reshape(3, 4, 8))
    assert torch.equal(two.reshape(12, 8), got[:12])
    assert torch.equal(fr.batch_inv(fr.from_int(vals[:1], CPU)), got[:1])


def test_plain_engine_limb_roundtrip():
    rng = np.random.default_rng(9)
    v = random_ints(rng, 6, fp.SPEC.r)
    w = fp.SPEC.words(v, CPU)
    assert torch.equal(limbs.limbs_to_words(limbs.words_to_limbs(w)), w)
    assert torch.equal(convert.words_from_ref(convert.words_to_ref(w), CPU), w)
