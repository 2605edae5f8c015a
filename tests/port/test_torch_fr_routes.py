"""The plain versions of the K1 and K2 route kernels (field/kernels.py:
fr_add_sub, fr_pow, fr_batch_inv, fr_fft_block, fr_zero_poly_leaves)
against the JAX package on seeded inputs, exactly: live where its compile
is short, else its recorded outputs (port_helpers.py), and Python ints.
The batch inversion and the block FFT run with their layouts forced small
(few threads a block, tiles of 2^1-2^3 values), so that several blocks,
chunk boundaries and 2-5 passes exercise the kernels' index math."""

import functools

import jax.numpy as jnp
import numpy as np
import oracle
import pytest
import torch
from port_helpers import (
    CPU,
    FFT_SCALES,
    batch_inv_input,
    edge_ints,
    fft_input,
    random_ints,
    reference,
    tree_missing,
    zero_poly_missing,
)

from kzg_tpu.field import fp as jfp
from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.das.zero_poly import leaf_layout
from kzg_tpu_torch.field import fp, fr
from kzg_tpu_torch.field import kernels as fk
from kzg_tpu_torch.field import limbs
from kzg_tpu_torch.ntt.bitrev import brp_permute
from kzg_tpu_torch.ntt.domain import FFTSettings

R = fr.SPEC.modulus
FIELDS = {"Fr": (jfr, fr), "Fp": (jfp, fp)}


def ints(t) -> list:
    return [int(v) for v in fr.to_int(t).reshape(-1)]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_add_sub_neg_match_reference(name):
    """Same-shape and both broadcast forms (one b element; a row of a
    broadcast against a batch), the edge values in every lane pairing."""
    jmod, mod = FIELDS[name]
    spec = mod.SPEC
    m = spec.modulus
    edges = edge_ints(m)
    av = random_ints(np.random.default_rng(40), 13, m) + edges
    bv = random_ints(np.random.default_rng(41), 13, m) + edges[::-1]
    a, b = mod.from_int(av, CPU), mod.from_int(bv, CPU)
    ja, jb = jnp.asarray(jmod.from_int(av)), jnp.asarray(jmod.from_int(bv))
    for op in ("add", "sub"):
        want = np.asarray(getattr(jmod, op)(ja, jb))
        got = fk.fr_add_sub(spec, op, a, b)
        assert torch.equal(got, convert.words_from_ref(want, CPU))
        got1 = fk.fr_add_sub(spec, op, a, b[5])
        want1 = np.asarray(getattr(jmod, op)(ja, jb[5]))
        assert torch.equal(got1, convert.words_from_ref(want1, CPU))
        got2 = fk.fr_add_sub(spec, op, b[5], a.reshape(2, 12, -1))
        py = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y}[op]
        assert list(mod.to_int(got2).reshape(-1)) == \
            [py(bv[5], x) % m for x in av]
    got = fk.fr_add_sub(spec, "neg", a)
    assert torch.equal(got, convert.words_from_ref(np.asarray(jmod.neg(ja)),
                                                   CPU))
    assert list(mod.to_int(got)) == [-x % m for x in av]


@pytest.mark.parametrize("name,e", [
    ("Fr", 0), ("Fr", 1), ("Fr", R - 2), ("Fr", 0xDEADBEEF12345678ABCDEF),
    ("Fp", fp.SPEC.modulus - 2)])
def test_pow_matches_reference(name, e):
    """a^e on the ladder, with 0 and 1 among the lanes: 0^0 = 1, 0^e = 0."""
    jmod, mod = FIELDS[name]
    m = mod.SPEC.modulus
    av = [0, 1, m - 1] + random_ints(np.random.default_rng(42), 5, m)
    got = fk.fr_pow(mod.SPEC, mod.from_int(av, CPU), e)
    if name == "Fr":
        want = np.asarray(jfr.pow_static(jnp.asarray(jfr.from_int(av)), e))
    else:
        want = np.asarray(jfp.inv(jnp.asarray(jfp.from_int(av))))
    assert torch.equal(got, convert.words_from_ref(want, CPU))
    assert list(mod.to_int(got)) == [pow(x, e, m) for x in av]


@pytest.mark.parametrize("name,e", [
    ("Fr", 0), ("Fr", 1), ("Fr", 2), ("Fr", 3), ("Fr", R - 2),
    ("Fp", fp.SPEC.modulus - 2)])
def test_pow_plain_equals_the_mont_mul_ladder(name, e):
    """fr_pow's plain version, a ladder of lazy products made canonical
    once, gives the words of the ladder of canonical Montgomery products."""
    _, mod = FIELDS[name]
    m = mod.SPEC.modulus
    a = mod.from_int([0, 1, m - 1] + random_ints(np.random.default_rng(43),
                                                 5, m), CPU)
    want = limbs.pow_static(mod.SPEC, functools.partial(limbs.mont_mul_plain,
                                                        mod.SPEC), a, e)
    assert torch.equal(fk.fr_pow_plain(mod.SPEC, a, e), want)


@pytest.mark.parametrize("threads,block_lanes", [
    (256, 8192), (4, 4), (2, 4), (2, 8), (4, 16)])
def test_batch_inv_layouts_match_reference(threads, block_lanes):
    """The recorded 13-lane case (zero lanes 3 and 9) under one block and
    under 2-4 blocks of 2-4 threads, chunks of 1-4 lanes."""
    vals = batch_inv_input()
    chunk, blocks = fk.inv_chunking(len(vals), threads, block_lanes)
    assert (blocks > 1) == (block_lanes < len(vals))
    got = fk.fr_batch_inv_plain(fr.SPEC, fr.from_int(vals, CPU), threads,
                                block_lanes)
    want = reference("batch_inv", jfr.from_int(vals))
    assert torch.equal(got, convert.words_from_ref(want, CPU))


def test_batch_inv_zero_lanes_at_chunk_boundaries():
    """300 lanes in 10 blocks of 4 threads x 8 lanes (the last block
    ragged), zero lanes at the first and last lane of chunks and blocks,
    a whole chunk of zeros, and a leading batch shape."""
    n = 300
    vals = random_ints(np.random.default_rng(43), n, R)
    for i in (0, 7, 8, 31, 32, 63, 64, 255, 256, 299) + tuple(range(96, 104)):
        vals[i] = 0
    assert fk.inv_chunking(n, 4, 32) == (8, 10)
    got = fk.fr_batch_inv_plain(fr.SPEC,
                                fr.from_int(vals, CPU).reshape(3, 100, 8),
                                4, 32)
    assert got.shape == (3, 100, 8)
    assert ints(got) == [pow(v, -1, R) if v else 0 for v in vals]
    # the wrapper's own layout: one block of 256 threads x 2 lanes
    assert torch.equal(fr.batch_inv(fr.from_int(vals, CPU)),
                       got.reshape(n, 8))


def test_batch_inv_refuses_too_many_blocks():
    with pytest.raises(ValueError):
        fk.fr_batch_inv_plain(fr.SPEC, fr.from_int(list(range(1, 20)), CPU),
                              2, 4)


@pytest.mark.parametrize("log_n,tiles", [(10, 11), (13, 11), (20, 11),
                                         (10, 3), (10, 2), (5, 1), (0, 3)])
def test_fft_plan(log_n, tiles):
    plan = fk.fft_plan(log_n, tiles)
    assert sum(plan) == log_n and max(plan) <= tiles
    assert len(plan) == max(1, -(-log_n // tiles))
    assert max(plan) - min(plan) <= 1


def radix2(x, roots, max_width: int):
    """K2's route, one plain stage at a time: bit reversal, then stage s
    with twiddle roots[j (max_width >> s)]."""
    y = brp_permute(x, axis=1)
    for s in range(1, x.shape[1].bit_length()):
        y = fk.fr_butterfly_stage_plain(fr.SPEC, y, roots, s - 1,
                                        max_width >> s)
    return y


@pytest.mark.parametrize("scale", FFT_SCALES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_block_matches_reference(scale, inverse):
    """Widths 2^4-2^10 with tiles of 2^2 and 2^3 values (2-5 passes)
    against the JAX package's FFT (recorded) and the radix-2 route."""
    vals = fft_input(scale)
    n = 1 << scale
    fs = FFTSettings(scale, CPU)
    roots = fs.reverse_roots_of_unity if inverse else \
        fs.expanded_roots_of_unity
    x = fr.from_int(vals, CPU).reshape(1, n, 8)
    want = convert.words_from_ref(
        reference(f"fft:{scale}:{int(inverse)}", jfr.from_int(vals)), CPU)
    inv_scale = pow(n, -1, R) if inverse else None
    for tiles in (2, 3):
        got = fk.fr_fft_block_plain(fr.SPEC, x, roots, n, inv_scale, tiles)
        assert torch.equal(got[0], want), tiles
    if not inverse:
        assert torch.equal(radix2(x, roots, n)[0], want)


@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 8])
def test_fft_block_batch_on_a_wider_domain(log_n):
    """A batch of 3 transforms of 2-256 points on the 2^9 domain (the
    twiddle stride), tiles of 2^1-2^3: the radix-2 route and, at the
    small widths, the DFT over Python ints."""
    n = 1 << log_n
    fs = FFTSettings(9, CPU)
    vals = random_ints(np.random.default_rng(44 + log_n), 3 * n, R)
    x = fr.from_int(vals, CPU).reshape(3, n, 8)
    want = radix2(x, fs.expanded_roots_of_unity, fs.max_width)
    for tiles in (1, 2, 3, fk.FFT_TILE_LOG):
        got = fk.fr_fft_block_plain(fr.SPEC, x, fs.expanded_roots_of_unity,
                                    fs.max_width, None, tiles)
        assert torch.equal(got, want), tiles
    if log_n <= 3:
        w = pow(fs.root_of_unity_int, fs.max_width // n, R)
        dft = [sum(v * pow(w, i * j, R) for j, v in enumerate(row)) % R
               for row in np.array(vals, dtype=object).reshape(3, n)
               for i in range(n)]
        assert ints(want) == dft


def test_fft_block_width_one_and_scale():
    """One point: no stage, only the scale."""
    fs = FFTSettings(3, CPU)
    x = fr.from_int([7, 9], CPU).reshape(2, 1, 8)
    got = fk.fr_fft_block_plain(fr.SPEC, x, fs.reverse_roots_of_unity, 8,
                                pow(4, -1, R))
    assert ints(got) == [7 * pow(4, -1, R) % R, 9 * pow(4, -1, R) % R]


def poly_mul(p: list, q: list) -> list:
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] = (out[i + j] + a * b) % R
    return out


def leaves_product(fs, missing, length: int):
    """The leaves of `missing` on the plain version, multiplied together
    over Python ints; -> (leaves, their product's coefficients)."""
    idx, valid, _ = leaf_layout(fs, np.asarray(missing, dtype=np.int64),
                                length, fs.max_width // length)
    leaves = fk.fr_zero_poly_leaves(fr.SPEC, fs.expanded_roots_of_unity, idx,
                                    valid)
    assert leaves.shape == (idx.shape[0], fk.LEAF_WIDTH, 8)
    prod = [1]
    for row in fr.to_int(leaves):
        prod = poly_mul(prod, [int(v) for v in row])
    assert not any(prod[length:])
    return leaves, (prod + [0] * length)[:length]


@pytest.mark.parametrize("case", ["tree", "6"])
def test_leaves_match_recorded_zero_polynomials(case):
    """Two full leaves (128 of 256 missing) and one partial leaf (48 of
    64): the product of the leaves is the JAX package's recorded zero
    polynomial."""
    if case == "tree":
        missing, length, fs = tree_missing(), 256, FFTSettings(9, CPU)
    else:
        missing, length, fs = zero_poly_missing(6, 0.75), 64, \
            FFTSettings(7, CPU)
    _, prod = leaves_product(fs, missing, length)
    want = reference(f"zero_poly:{case}", missing)[1]
    want = ints(convert.words_from_ref(want, CPU))
    assert prod == want


def test_leaves_partial_and_padding():
    """130 missing of 512: two full leaves, a partial one of 2 factors and
    a padding leaf (all invalid) that is the constant 1; each leaf is the
    product of its own factors."""
    fs = FFTSettings(9, CPU)
    missing = sorted(np.random.default_rng(45).choice(
        512, size=130, replace=False).tolist())
    leaves, prod = leaves_product(fs, missing, 512)
    assert leaves.shape[0] == 4
    rows = [[int(v) for v in row] for row in fr.to_int(leaves)]
    assert rows[3] == [1] + [0] * (fk.LEAF_WIDTH - 1)
    for g, chunk in enumerate((missing[:64], missing[64:128],
                               missing[128:])):
        assert rows[g][:len(chunk) + 1] == \
            oracle.zero_poly(chunk, 512, 512)[1][:len(chunk) + 1]
        assert not any(rows[g][len(chunk) + 1:])
    assert prod == oracle.zero_poly(missing, 512, 512)[1]


def test_leaves_skip_invalid_factors_anywhere():
    """Validity need not be a prefix: an invalid factor is the identity
    wherever it stands."""
    fs = FFTSettings(6, CPU)
    idx = np.arange(2 * fk.LEAF_FACTORS, dtype=np.int32).reshape(2, -1) % 64
    valid = np.zeros_like(idx, dtype=bool)
    valid[0, [3, 10, 63]] = True
    valid[1, [0, 40]] = True
    got = fk.fr_zero_poly_leaves(fr.SPEC, fs.expanded_roots_of_unity, idx,
                                 valid)
    roots = fs.roots_of_unity_int()
    for g in range(2):
        want = [1]
        for s in np.flatnonzero(valid[g]):
            want = poly_mul(want, [-roots[idx[g, s]] % R, 1])
        assert ints(got[g])[:len(want)] == want
