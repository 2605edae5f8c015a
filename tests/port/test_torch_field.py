"""Fr/Fp arithmetic of the port against the JAX package, and the kernel
wrappers of field/kernels.py (K1 mont_mul, fr_scale, K2) on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import CPU, edge_ints, random_ints

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
    assert kernels.LAUNCHES == {"mont_mul": 0, "fr_scale": 0,
                                "fr_butterfly_stage": 0, "fr_dif_stage": 0}


def test_plain_engine_limb_roundtrip():
    rng = np.random.default_rng(9)
    v = random_ints(rng, 6, fp.SPEC.r)
    w = fp.SPEC.words(v, CPU)
    assert torch.equal(limbs.limbs_to_words(limbs.words_to_limbs(w)), w)
    assert torch.equal(convert.words_from_ref(convert.words_to_ref(w), CPU), w)
