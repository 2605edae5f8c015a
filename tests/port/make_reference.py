#!/usr/bin/env python3
"""Record the JAX package's outputs for the port's tests.

    python tests/port/make_reference.py            # every group, hours
    python tests/port/make_reference.py das msm    # only these groups

Runs kzg_tpu on its CPU "vector" engine, set up as its own tests set it
up (the root conftest.py), on the inputs that port_helpers.py builds, and
writes port_helpers.REFERENCE_FILE. The Pallas kernels that the port
replaces run in interpret mode, as the JAX package's own tests run them.
Each record stores a hash of its inputs beside the outputs. Naming groups
re-records only those and keeps the file's other records. Rerun a group
only if its inputs change; kzg_tpu itself is frozen.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, as for the JAX tests)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import port_helpers as ph  # noqa: E402
from test_das import GOLDEN_ZP_MISSING  # noqa: E402

from kzg_tpu import poly  # noqa: E402
from kzg_tpu.curve import g1  # noqa: E402
from kzg_tpu.curve import pallas_g1  # noqa: E402
from kzg_tpu.curve.fft_g1 import fft_g1  # noqa: E402
from kzg_tpu.curve.msm import lin_comb_g1, tree_reduce  # noqa: E402
from kzg_tpu.das import batch_inv as legacy_batch_inv  # noqa: E402
from kzg_tpu.das import (  # noqa: E402
    erasure_code_recover,
    recover_poly_from_samples,
    shift_poly,
    unshift_poly,
)
from kzg_tpu.das.zero_poly import zero_poly_via_multiplication  # noqa: E402
from kzg_tpu.field import fp, fr  # noqa: E402
from kzg_tpu.field.backend import set_field_backend  # noqa: E402
from kzg_tpu.field.pallas_kernels import (  # noqa: E402
    butterfly_lazy_dif,
    butterfly_pallas,
)
from kzg_tpu.fk20 import FK20MultiSettings, FK20SingleSettings  # noqa: E402
from kzg_tpu.kzg import KZGSettings, generate_testing_setup  # noqa: E402
from kzg_tpu.ntt import FFTSettings, fft  # noqa: E402
from kzg_tpu.ntt.das import _das_core, _das_stage_tws  # noqa: E402


def kzg_env():
    """The kzg_env fixture's settings (tests/conftest.py)."""
    s1, _, a1, a2 = generate_testing_setup(ph.TEST_SECRET, ph.CRS_SIZE)
    return KZGSettings(FFTSettings(5), s1, a2, a1)


def record_fft(put):
    for scale in ph.FFT_SCALES:
        vals = fr.from_int(ph.fft_input(scale))
        for inverse in (False, True):
            put(f"fft:{scale}:{int(inverse)}",
                fft(FFTSettings(scale), jnp.asarray(vals), inverse), vals)


def record_g1(put):
    _, pts, ks = ph.mul_case()
    p, sc = ph.port_to_ref(pts), fr.from_int(ks)
    put("g1_mul", tuple(g1.mul(p, jnp.asarray(sc))), *p, sc)

    _, pts = ph.fft_g1_case()
    p = ph.port_to_ref(pts)
    for inverse in (False, True):
        put(f"fft_g1:{int(inverse)}", tuple(fft_g1(FFTSettings(5), p, inverse)),
            *p)

    _, batch = ph.tree_reduce_case()
    p = ph.port_to_ref(batch)
    put("tree_reduce", tuple(tree_reduce(g1.ops, p)), *p)


def record_fk20(put):
    ks = kzg_env()
    put("crs", tuple(ks.secret_g1), ph.TEST_SECRET, ph.CRS_SIZE)
    poly = fr.from_int(ph.FK20_COEFFS)
    ext = fr.from_int(ph.FK20_COEFFS + [0] * ph.FK20_N)
    for l in ph.FK20_CHUNKS:
        fkm = FK20MultiSettings(ks, ph.FK20_N2, l)
        put(f"fk20:{l}:tables", tuple(fkm.x_ext_fft_files),
            ph.TEST_SECRET, ph.CRS_SIZE, l)
        put(f"fk20:{l}:da", tuple(fkm.da_using_fk20_multi(jnp.asarray(poly))),
            poly, l)
        put(f"fk20:{l}:da_optimized",
            tuple(fkm.fk20_multi_da_optimized(jnp.asarray(ext))), ext, l)


def record_g1_add(put):
    """The fused add/double kernels (_add_fn, _double_fn), interpreted."""
    _, _, p, q = ph.g1_add_case()
    rp, rq = ph.port_to_ref(p), ph.port_to_ref(q)
    put("g1_add:pq", tuple(pallas_g1.add_pallas(rp, rq)), *rp, *rq)
    put("g1_add:qp", tuple(pallas_g1.add_pallas(rq, rp)), *rp, *rq)
    put("g1_double", tuple(pallas_g1.double_pallas(rp)), *rp)


def record_msm(put):
    ks = kzg_env()
    sc = fr.from_int(ph.msm_scalars())
    put("lin_comb_g1", tuple(lin_comb_g1(ks.secret_g1, jnp.asarray(sc))),
        ph.TEST_SECRET, ph.CRS_SIZE, sc)
    coeffs = fr.from_int(ph.FK20_COEFFS)
    put("commit_to_poly", tuple(ks.commit_to_poly(jnp.asarray(coeffs))),
        ph.TEST_SECRET, ph.CRS_SIZE, coeffs)


def das_pallas(fs, vals, interleave: bool):
    """The half-FFT extension of _das_core_pallas (_butterfly_lazy_dif_fn
    down, _butterfly_lazy_fn up, _canon_scale_fn exit), interpreted."""
    set_field_backend("pallas")
    try:
        return _das_core.__wrapped__(
            jnp.asarray(vals), fs.expanded_roots_of_unity,
            fs.reverse_roots_of_unity, max_width=fs.max_width,
            interleave=interleave)
    finally:
        set_field_backend("auto")


def record_das(put):
    for log_n, scale in ph.DAS_CASES:
        vals = fr.from_int(ph.das_input(log_n))
        put(f"das:{log_n}", das_pallas(FFTSettings(scale), vals, False),
            vals, scale)
    evens = fr.from_int(ph.slice_evens())
    put("das_interleaved", das_pallas(FFTSettings(5), evens, True), evens)

    # the first down-sweep level of the n = 64 case on its own: lane
    # layout in, lazy R-form (17, 32) values out
    log_n, scale = ph.DAS_CASES[1]
    vals = fr.from_int(ph.das_input(log_n))
    half = 1 << (log_n - 1)
    a, b = (jnp.asarray(vals[s].T) for s in (slice(0, half), slice(half, None)))
    down, _, _ = _das_stage_tws(scale, 1 << log_n)
    hi, lo = butterfly_lazy_dif(fr.SPEC, a, b, jnp.asarray(down[0]),
                                first=True, reduce_hi=False)
    put("dif_level", np.stack([np.asarray(hi), np.asarray(lo)]), vals, scale)


def record_field(put):
    """_butterfly_fn interpreted, and the zero-masked batch inversion."""
    for jmod in (fr, fp):
        abt = jmod.from_int(ph.butterfly_input(jmod.SPEC.modulus))
        hi, lo = butterfly_pallas(jmod.SPEC, *(jnp.asarray(v) for v in abt))
        put(f"butterfly:{jmod.SPEC.name}", np.stack([hi, lo]), abt)
    vals = fr.from_int(ph.batch_inv_input())
    put("batch_inv", fr.batch_inv(jnp.asarray(vals)), vals)


def record_poly(put):
    c = ph.poly_case()
    coeffs, xs = fr.from_int(c["coeffs"]), fr.from_int(c["xs"])
    put("poly:eval_at", poly.eval_poly_at(jnp.asarray(coeffs),
                                          jnp.asarray(xs)), coeffs, xs)
    put("poly:eval_at_parallel", np.stack([
        poly.eval_poly_at_parallel(jnp.asarray(coeffs), jnp.asarray(x))
        for x in xs]), coeffs, xs)
    x = fr.from_int(ph.POWERS_X)
    put("poly:powers_of", poly.powers_of(jnp.asarray(x), ph.POWERS_N), x)
    vals = fr.from_int(c["sum"])
    put("poly:sum_fr", poly.sum_fr(jnp.asarray(vals), axis=0), vals)
    polys, sc = fr.from_int(c["polys"]), fr.from_int(c["scalars"])
    put("poly:lin_comb", poly.poly_lin_comb(jnp.asarray(polys),
                                            jnp.asarray(sc)), polys, sc)
    p, z = fr.from_int(c["p"]), fr.from_int(c["z"])
    put("poly:factor_div", poly.poly_factor_div(jnp.asarray(p),
                                                jnp.asarray(z)), p, z)
    a, b = fr.from_int(c["dividend"]), fr.from_int(c["divisor"])
    put("poly:long_div", poly.poly_long_div(jnp.asarray(a), jnp.asarray(b)),
        a, b)
    c16, z = fr.from_int(c["c16"]), fr.from_int(ph.POLY_Z)
    put("poly:quotient_on_domain", poly.poly_quotient_on_domain(
        FFTSettings(5), jnp.asarray(c16), jnp.asarray(z)), c16, z)
    fs = FFTSettings(4)
    evals = jnp.asarray(fft(fs, jnp.asarray(c16)))
    domain = jnp.asarray(fr.from_int([pow(fs.root_of_unity_int, i,
                                          fr.SPEC.modulus)
                                      for i in range(16)]))
    width_inv = jnp.asarray(fr.from_int(pow(16, -1, fr.SPEC.modulus)))
    for name, x in (("off", fr.from_int(ph.POLY_X)), ("on", domain[5])):
        put(f"poly:eval_form:{name}", poly.eval_poly_in_evaluation_form(
            evals, domain, jnp.asarray(x), width_inv), c16, x)


def record_recovery(put):
    for scale, ratio in ph.ZERO_POLY_CASES:
        missing = ph.zero_poly_missing(scale, ratio)
        put(f"zero_poly:{scale}", np.stack(zero_poly_via_multiplication(
            FFTSettings(scale + 1), missing, 1 << scale)), missing)
    put("zero_poly:golden", np.stack(zero_poly_via_multiplication(
        FFTSettings(4), GOLDEN_ZP_MISSING, 16)), GOLDEN_ZP_MISSING)
    missing = ph.tree_missing()
    put("zero_poly:tree", np.stack(zero_poly_via_multiplication(
        FFTSettings(9), missing, 256)), missing)
    vals = fr.from_int(list(range(1, 9)))
    put("shift_poly", np.stack([shift_poly(jnp.asarray(vals)),
                                unshift_poly(jnp.asarray(vals))]), vals)
    vals = fr.from_int([v or 1 for v in ph.batch_inv_input()])
    put("legacy_batch_inv", legacy_batch_inv(jnp.asarray(vals)), vals)
    for seed, ratio in ph.RECOVERY_CASES:
        _, samples, missing = ph.recovery_case(seed, ratio)
        s = fr.from_int(samples)
        put(f"recover:{seed}", recover_poly_from_samples(
            FFTSettings(6), jnp.asarray(s), missing), s, missing)
    samples, missing = ph.erasure_only_case()
    s = fr.from_int(samples)
    put("recover:erasure_only", recover_poly_from_samples(
        FFTSettings(5), jnp.asarray(s), missing), s, missing)
    for scale, seed in ph.LEGACY_CASES:
        _, samples, missing = ph.recovery_case(seed, 0.5, scale)
        s = fr.from_int(samples)
        fs = FFTSettings(scale + 1)
        put(f"legacy:{seed}", np.stack([
            erasure_code_recover(fs, jnp.asarray(s), missing),
            recover_poly_from_samples(fs, jnp.asarray(s), missing)]),
            s, missing)


def record_proofs(put):
    ks = kzg_env()
    coeffs = fr.from_int(ph.PROOF_COEFFS)
    for method in ("auto", "serial"):
        put(f"proof_single:{method}", tuple(ks.compute_proof_single(
            jnp.asarray(coeffs), ph.PROOF_X, method=method)),
            ph.TEST_SECRET, ph.CRS_SIZE, coeffs, ph.PROOF_X)
    put("proof_multi", tuple(ks.compute_proof_multi(
        jnp.asarray(coeffs), ph.MULTI_X, ph.MULTI_N)),
        ph.TEST_SECRET, ph.CRS_SIZE, coeffs, ph.MULTI_X, ph.MULTI_N)
    fk = FK20SingleSettings(ks, ph.FK20_N2)
    put("fk20_single:tables", tuple(fk.x_ext_fft), ph.TEST_SECRET,
        ph.CRS_SIZE, ph.FK20_N2)
    poly_ = fr.from_int(ph.FK20_COEFFS)
    ext = fr.from_int(ph.FK20_COEFFS + [0] * ph.FK20_N)
    put("fk20_single:single", tuple(fk.fk20_single(jnp.asarray(poly_))),
        poly_)
    put("fk20_single:da", tuple(fk.da_using_fk20(jnp.asarray(poly_))), poly_)
    put("fk20_single:da_optimized",
        tuple(fk.fk20_single_da_optimized(jnp.asarray(ext))), ext)


def record_verify(put):
    """The batch decompression, the device final exponentiation, the
    Miller loop with it, and check_proof_multi."""
    from kzg_tpu.curve import fp2, serialization, tower
    from kzg_tpu.curve.pairing_device import (
        _embed_fp,
        final_exponentiation,
        miller_loop_batched,
        untwist_g2,
    )

    pts, good, off, bad = ph.decompress_case()
    put("decompress:good", ph.affine_bytes(
        serialization.decompress_g1_batch(good)), *good)
    put("decompress:off_unchecked", ph.affine_bytes(
        serialization.decompress_g1_batch([off], subgroup_check=False)), off)
    for key, enc in (("decompress:off", [off]), ("decompress:bad", [bad])):
        try:
            serialization.decompress_g1_batch(enc)
            msg = "accepted"
        except ValueError as e:
            msg = str(e)
        put(key, np.asarray(msg), *enc)

    f_ints = ph.random_f12_ints(130, ph.FEXP_LANES)
    f = tower.f12_from_int(f_ints)
    put("final_exp", jax.jit(final_exponentiation)(jnp.asarray(f)), f)

    case = ph.miller_case()
    p_ = g1.from_affine_ints([c[0] for c in case])
    xa, ya, _ = g1.ops.to_affine(p_)
    x2 = jnp.asarray(fp2.from_int([list(c[1][0]) for c in case]))
    y2 = jnp.asarray(fp2.from_int([list(c[1][1]) for c in case]))

    def miller_fe(x2, y2, xa, ya):
        xq, yq = untwist_g2(x2, y2)
        num, den = miller_loop_batched(xq, yq, _embed_fp(xa), _embed_fp(ya))
        return final_exponentiation(
            tower.f12_mul(num, tower.f12_inv(den)))

    put("miller_final_exp", jax.jit(miller_fe)(x2, y2, xa, ya),
        repr(case))

    ks = kzg_env()
    coeffs = jnp.asarray(fr.from_int(ph.PROOF_COEFFS))
    commitment = ks.commit_to_poly(coeffs)
    proof = ks.compute_proof_multi(coeffs, ph.MULTI_X, ph.MULTI_N)
    got = [ks.check_proof_multi(commitment, proof, ph.MULTI_X,
                                jnp.asarray(fr.from_int(ys)))
           for ys in ph.multi_case()]
    put("check_proof_multi", np.asarray(got), ph.TEST_SECRET, ph.CRS_SIZE,
        ph.PROOF_COEFFS, ph.MULTI_X, ph.MULTI_N, ph.multi_case())


def record_verify_batch(put):
    """check_proof_multi_batch on tests/test_pairing_device.py:116-147's
    case. kzg_tpu jits the whole check as one program, whose compile on
    the CPU runs LLVM out of memory; so the recorder runs the same
    function op by op (its pieces, the Miller scan and the final
    exponentiation among them, compile one at a time)."""
    import kzg_tpu.kzg.settings as ksettings
    from kzg_tpu.curve.weierstrass import JacobianPoint

    ks = kzg_env()
    coeffs = jnp.asarray(fr.from_int(ph.BATCH_COEFFS))
    commitment = ks.commit_to_poly(coeffs)
    proofs = [ks.compute_proof_multi(coeffs, x, ph.BATCH_M)
              for x in ph.BATCH_XS]
    proofs_b = JacobianPoint(*(jnp.stack([p[i] for p in proofs])
                               for i in range(3)))
    rows = ph.batch_case()
    jitted = ksettings._check_multi_batch
    ksettings._check_multi_batch = jitted.__wrapped__
    try:
        got = ks.check_proof_multi_batch(commitment, proofs_b, ph.BATCH_XS,
                                         jnp.asarray(fr.from_int(rows)))
    finally:
        ksettings._check_multi_batch = jitted
    put("check_proof_multi_batch", np.asarray(got), ph.TEST_SECRET,
        ph.CRS_SIZE, ph.BATCH_COEFFS, ph.BATCH_XS, rows)


def record_eth(put):
    """eth_env (tests/conftest.py) and the calls of ph.eth_cases."""
    from kzg_tpu import eth

    es = eth.EthSettings.insecure(ph.ETH_SECRET, ph.ETH_WIDTH)
    blobs = ph.eth_blobs()
    for name, text in ph.eth_cases(eth, fr.to_int, es, blobs).items():
        put(f"eth:{name}", np.asarray(text), ph.ETH_SECRET, ph.ETH_WIDTH,
            *blobs)


def record_fft_g1_generic(put):
    """fft_g1's route for any curve point (in_subgroup=False), on points
    off the r-torsion."""
    for n in (8, 16):
        _, pts = ph.off_subgroup_case(n)
        p = ph.port_to_ref(pts)
        for inverse in (False, True):
            put(f"fft_g1_generic:{n}:{int(inverse)}", tuple(fft_g1(
                FFTSettings(ph.FFT_G1_GENERIC_SCALE), p, inverse,
                in_subgroup=False)), *p)


def record_persist(put):
    """The arrays that kzg_tpu's save_* write for kzg_env's settings and
    its FK20 settings at (16, 2) and 16."""
    import tempfile

    from kzg_tpu.kzg import persist

    ks = kzg_env()
    objs = (("kzg", persist.save_kzg_settings, ks),
            ("fk20_multi", persist.save_fk20_multi,
             FK20MultiSettings(ks, ph.FK20_N2, 2)),
            ("fk20_single", persist.save_fk20_single,
             FK20SingleSettings(ks, ph.FK20_N2)))
    with tempfile.TemporaryDirectory() as d:
        for name, save, obj in objs:
            path = os.path.join(d, name + ".npz")
            save(path, obj)
            with np.load(path) as f:
                for k in f.files:
                    put(f"persist:{name}:{k}", f[k], ph.TEST_SECRET,
                        ph.CRS_SIZE, name)


def record_parallel(put):
    """kzg_tpu.parallel's Fr FFT, shuffle and MSM on make_mesh(D, axes=
    ("elem",)) over the root conftest's virtual CPU devices, and the
    local G1 inverse with the global 1/n (_fft_g1_core with inv_n)."""
    from kzg_tpu.curve.fft_g1 import _fft_g1_core
    from kzg_tpu.parallel import (
        fft_sharded,
        lin_comb_g1_sharded,
        make_mesh,
        reverse_bit_order_g1_sharded,
    )

    fs = FFTSettings(ph.PAR_SCALE)
    vals = fr.from_int(ph.parallel_fft_input())
    _, pts = ph.parallel_g1_case(ph.PAR_G1_N)
    p = ph.port_to_ref(pts)
    for D in ph.PAR_DS:
        mesh = make_mesh(D, axes=("elem",))
        for inverse in (False, True):
            put(f"par_fft:{D}:{int(inverse)}", fft_sharded(
                fs, jnp.asarray(vals), mesh, inverse=inverse), vals)
        put(f"par_brp_g1:{D}", tuple(reverse_bit_order_g1_sharded(p, mesh)),
            *p)
        for n in ph.PAR_MSM_NS:
            _, mp = ph.parallel_g1_case(n)
            rp = ph.port_to_ref(mp)
            sc = fr.from_int(ph.parallel_msm_scalars(n))
            put(f"par_msm:{D}:{n}", tuple(lin_comb_g1_sharded(
                rp, jnp.asarray(sc), mesh)), *rp, sc)
    _, cp = ph.parallel_g1_case(ph.PAR_CORE_N)
    rp = ph.port_to_ref(cp)
    inv_n = jnp.asarray(fr.from_int(pow(2 * ph.PAR_CORE_N, -1,
                                        fr.SPEC.modulus)))
    put("par_g1_core_inv", tuple(_fft_g1_core(
        *rp, fs.reverse_roots_of_unity, inv_n, max_width=fs.max_width)), *rp)


def record_parallel_g1(put):
    """kzg_tpu.parallel's G1 FFT on make_mesh(D, axes=("elem",))."""
    from kzg_tpu.parallel import fft_g1_sharded, make_mesh

    fs = FFTSettings(ph.PAR_SCALE)
    _, pts = ph.parallel_g1_case(ph.PAR_G1_N)
    p = ph.port_to_ref(pts)
    for D in ph.PAR_DS:
        mesh = make_mesh(D, axes=("elem",))
        for inverse in (False, True):
            put(f"par_fft_g1:{D}:{int(inverse)}", tuple(fft_g1_sharded(
                fs, p, mesh, inverse=inverse)), *p)


# the field-chain experiments: scripts/exp_montmul.py runs its work at
# import, so its inputs and variant A's loop are written out here;
# scripts/exp_mxu_mul.py keeps its work under main() and is imported
EXP_DEPTH = 8


def _exp_script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _const_col(limbs_np):
    return jnp.asarray(np.asarray(limbs_np, dtype=np.uint32)[:, None])


def record_exp_field(put):
    """X1's variant A body (mont_mul_tile in lax.fori_loop, Fr and Fp),
    X2's interpreted pallas_hybrid_mul_fn, mxu_const_mul and
    hybrid_mont_mul, and X12's six tile ops, on the scripts' inputs."""
    from jax import lax

    from kzg_tpu.field.pallas_kernels import (
        _carry_fold, _cond_sub_mod, _const_tiles, _geq, mod_add_tile,
        mod_sub_tile, mont_mul_tile)

    for jmod in (fr, fp):
        spec = jmod.SPEC
        rng = np.random.default_rng(42)         # exp_montmul.py:219-229
        av = np.stack([np.asarray(spec.encode(int.from_bytes(
            rng.bytes(31), "little"))) for _ in range(64)]).T
        a, b = av, np.ascontiguousarray(av[:, ::-1])
        mod, npr = _const_col(spec.mod_limbs), _const_col(spec.nprime_limbs)
        chain = jax.jit(lambda x, y: lax.fori_loop(
            0, EXP_DEPTH, lambda _, v: mont_mul_tile(mod, npr, v, y), x))
        put(f"exp_montmul:{spec.name}", chain(jnp.asarray(a), jnp.asarray(b)),
            a, b, EXP_DEPTH)

    mx = _exp_script("exp_mxu_mul")
    L = mx.L
    rng = np.random.default_rng(7)              # exp_mxu_mul.py:286-297

    def draw():
        v = 1
        for _ in range(6):
            v *= int(rng.integers(0, 1 << 62))
        return v % mx.MOD

    xs = [draw() for _ in range(256)]
    ys = [draw() for _ in range(256)]
    a16 = np.stack([mx.limbs_of(v, L) for v in xs])
    b16 = np.stack([mx.limbs_of(v, L) for v in ys])
    np_t = jnp.asarray(mx.toeplitz_digits(mx.NPRIME, 2 * L, 2 * L)).astype(
        jnp.bfloat16)
    m_t = jnp.asarray(mx.toeplitz_digits(mx.MOD, 2 * L, 4 * L)).astype(
        jnp.bfloat16)
    put("exp_mxu_mul:mxu_const_mul", jax.jit(
        lambda x: mx.mxu_const_mul(x, np_t, L))(jnp.asarray(a16)), a16)
    put("exp_mxu_mul:hybrid_mont_mul", jax.jit(
        lambda x, y: mx.hybrid_mont_mul(x, y, np_t, m_t, jnp.asarray(
            mx.limbs_of(mx.MOD, L))))(jnp.asarray(a16), jnp.asarray(b16)),
        a16, b16)
    mod_t, _ = _const_tiles(fp.SPEC)
    planes = [jnp.asarray(v).astype(jnp.bfloat16) for v in (
        *mx.toeplitz16_bytes(mx.NPRIME, L, L),
        *mx.toeplitz16_bytes(mx.MOD, L, 2 * L))]
    pk = mx.pallas_hybrid_mul_fn(256, 128, interpret=True)
    put("exp_mxu_mul:pallas_hybrid", pk(mod_t, *planes, jnp.asarray(a16.T),
                                        jnp.asarray(b16.T)), a16, b16)

    spec = fp.SPEC
    rng = np.random.default_rng(1)              # exp_addsub.py:59-63
    av = np.stack([np.asarray(spec.encode(int.from_bytes(
        rng.bytes(40), "little"))) for _ in range(64)]).T
    mod, npr = _const_col(spec.mod_limbs), _const_col(spec.nprime_limbs)
    ops = {                                     # exp_addsub.py:73-82
        "mont_mul(x,c)": lambda x: mont_mul_tile(
            mod, npr, x, jnp.broadcast_to(npr, x.shape)),
        "mod_add(x,x)": lambda x: mod_add_tile(mod, x, x),
        "mod_sub(m,x)": lambda x: mod_sub_tile(
            mod, jnp.broadcast_to(mod, x.shape), x),
        "carry_fold": lambda x: _carry_fold(x)[:x.shape[0]],
        "geq+where": lambda x: jnp.where(
            _geq(x, jnp.broadcast_to(mod, x.shape))[None, :], x,
            jnp.broadcast_to(mod, x.shape)),
        "cond_sub": lambda x: _cond_sub_mod(mod, x),
    }
    for name, op in ops.items():
        chain = jax.jit(lambda x, op=op: lax.fori_loop(
            0, EXP_DEPTH, lambda _, v: op(v), x))
        put(f"exp_addsub:{name}", chain(jnp.asarray(av)), av, EXP_DEPTH)


def record_exp_chain(put):
    """X4's and X5's 7-product bodies (mont_mul_tile at 24 rows,
    lazy_mul_tile at 24, 25 and 32 rows on the scripts' zero-padded
    modulus and n'; the three carries) and X6's and X11's 8-product body
    in the lazy domain (to_ext, lazy_mul_tile at LL = 25, from_ext, on
    _kernel_ctx's constants) for five of the six variants (raw12's
    16-bit carries have no 32-bit counterpart) and subs1 (one lazy sub,
    whose output is not the zero subs12 leaves), at depth EXP_DEPTH on 64
    lanes; tuple3 and adds12 through the scripts' pl.pallas_call shapes
    in interpret mode. The points are the port's (exp_addcost.inputs):
    the scripts' multiples of the generator as host Jacobian
    coordinates."""
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from kzg_tpu.field.pallas_kernels import (
        LIMB_MASK, _carry_fold, _const_spec, lazy_add_tile, lazy_mul_tile,
        lazy_sub_tile, mont_mul_tile)
    from kzg_tpu_torch import convert
    from kzg_tpu_torch.experiments import exp_addcost

    spec, D, W = fp.SPEC, EXP_DEPTH, 64
    U32 = jnp.uint32
    rng = np.random.default_rng(3)              # exp_ab_mul.py:39-43
    av = np.stack([np.asarray(spec.encode(int.from_bytes(
        rng.bytes(40), "little"))) for _ in range(64)]).T.astype(np.uint32)

    def seven(M, x, y, z):                      # exp_carry.py:55-63
        a, b, c = M(x, y), M(y, z), M(z, x)
        d, e = M(a, b), M(b, c)
        return M(d, e), M(e, a), c

    def padded(limbs_np, rows):                 # exp_ab_mul.py:47-52
        out = np.zeros((rows, 128), np.uint32)
        out[:24] = np.asarray(limbs_np, np.uint32)[:, None]
        return jnp.asarray(out)

    for name, rows, mul in (("mont24", 24, mont_mul_tile),
                            ("lazy24", 24, lazy_mul_tile),
                            ("lazy25", 25, lazy_mul_tile),
                            ("lazy32", 32, lazy_mul_tile)):
        mod = padded(spec.mod_limbs, rows)[:, :1]
        npr = padded(spec.nprime_limbs, rows)[:, :1]
        x0 = np.zeros((rows, W), np.uint32)
        x0[:24] = av
        chain = jax.jit(lambda x, mod=mod, npr=npr, mul=mul: lax.fori_loop(
            0, D, lambda _, p: seven(lambda a, b: mul(mod, npr, a, b), *p),
            (x, x, x))[0])
        put(f"exp_ab_mul:{name}", chain(jnp.asarray(x0)), av, D)

    mod_t, npr_t = padded(spec.mod_limbs, 24), padded(spec.nprime_limbs, 24)

    def M24(a, b):
        return mont_mul_tile(mod_t[:, :1], npr_t[:, :1], a, b)

    def tuple3_kernel(mod_ref, npr_ref, px, py, pz, ox, oy, oz):
        mod, npr = mod_ref[:, :1], npr_ref[:, :1]   # exp_carry.py:68-86
        out = lax.fori_loop(0, D, lambda _, p: seven(
            lambda a, b: mont_mul_tile(mod, npr, a, b), *p),
            (px[:], py[:], pz[:]))
        ox[:], oy[:], oz[:] = out

    bspec = pl.BlockSpec((24, W), lambda i: (0, i), memory_space=pltpu.VMEM)
    tuple3 = pl.pallas_call(
        tuple3_kernel, grid=(1,), in_specs=[_const_spec(24)] * 2
        + [bspec] * 3, out_specs=(bspec,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((24, W), U32)
                        for _ in range(3)), interpret=True)
    a = jnp.asarray(av)
    put("exp_carry:tuple3", tuple3(mod_t, npr_t, a, a, a)[0], av, D)
    single = jax.jit(lambda w: lax.fori_loop(     # exp_carry.py:95-99
        0, D, lambda _, w: jnp.concatenate(seven(
            M24, w[:24], w[24:48], w[48:]), axis=0), w)[:24])
    put("exp_carry:single", single(jnp.concatenate([a, a, a], axis=0)),
        av, D)

    def seven_squares(_, x):                    # exp_carry.py:117-121
        for _ in range(7):
            x = M24(x, x)
        return x

    serial = jax.jit(lambda x: lax.fori_loop(0, D, seven_squares, x))
    put("exp_carry:serial", serial(a), av, D)

    pts = [np.ascontiguousarray(convert.words_to_ref(c).T)
           for c in exp_addcost.inputs(W, "cpu")]
    csts = pallas_g1._cst()[:5]

    def ext_body(crefs, kind, nextra, x, y, z):   # exp_addcost.py:59-93
        lz, cin, cout, _ = pallas_g1._kernel_ctx(crefs)
        modx, nprx, km = lz[:3]

        def M(a, b):
            return lazy_mul_tile(modx, nprx, a, b)

        E = {"adds": lazy_add_tile,
             "subs": lambda a, b: lazy_sub_tile(km, a, b),
             "fold": lambda a, b: _carry_fold(a + b),
             "raw": lambda a, b: (a + b) & LIMB_MASK}[kind]

        def body(_, p):
            x, y, z = p
            a, b, c = M(x, y), M(y, z), M(z, x)
            for j in range(nextra):
                c = E((a, b, c)[j % 3], c)
            d, e = M(a, b), M(b, c)
            f, g = M(d, e), M(e, a)
            return f, g, M(f, g)

        p = tuple(pallas_g1.to_ext(lz, cin, c) for c in (x, y, z))
        out = lax.fori_loop(0, D, body, p)
        return tuple(pallas_g1.from_ext(lz, cout, c) for c in out)

    for kind, nextra in (("adds", 0), ("adds", 4), ("subs", 12),
                         ("fold", 12), ("subs", 1)):
        fn = jax.jit(lambda *v, kind=kind, nextra=nextra: ext_body(
            v[:5], kind, nextra, *v[5:]))
        put(f"exp_addcost:{kind}{nextra}",
            fn(*csts, *(jnp.asarray(c) for c in pts)), *pts, D)

    def adds12_kernel(mr, nr, cir, cor, oner, px, py, pz, ox, oy, oz):
        out = ext_body((mr, nr, cir, cor, oner), "adds", 12, px[:], py[:],
                       pz[:])
        ox[:], oy[:], oz[:] = out

    adds12 = pl.pallas_call(                    # exp_addcost.py:95-100
        adds12_kernel, grid=(1,),
        in_specs=[_const_spec(pallas_g1.LL)] * 5 + [bspec] * 3,
        out_specs=(bspec,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((24, W), U32)
                        for _ in range(3)), interpret=True)
    put("exp_addcost:adds12", adds12(*csts, *(jnp.asarray(c) for c in pts)),
        *pts, D)


def record_exp_point(put):
    """X3, X7, X8, X9 and X10 (scripts/exp_calib.py, exp_bisect.py,
    exp_width.py, exp_pointops.py, exp_lazyops.py) at depth EXP_DEPTH on
    64 lanes of each script's points, the port's host Jacobian multiples
    of the generator (exp_addcost.inputs with the script's seed and the
    40-byte values it draws first): one site a script through its
    pl.pallas_call shape in interpret mode (exp_calib's projdbl,
    exp_bisect's transp, exp_width's serial8, exp_pointops' mul_chain,
    exp_lazyops' mulref chain), the other cases as the same bodies under
    jax.jit (exp_lazyops' window step op by op). X3's and X7's product chains on the 64 values are
    exp_chain's exp_ab_mul:mont24 and :lazy25. Two scripts no longer run
    against kzg_tpu as written, and this writes out what they meant:
    exp_pointops.py:116 calls _table_build_body(mod, npr, tx, ty, tz),
    which now builds a lazy projective table from (lz, tx, ty, tz), so the
    Jacobian [1..8]P is built here by point_add_tile, (k+1)P = kP + P; and
    exp_lazyops.py:158 unpacks three of _lazy_ctx's four values, so lz[:3]
    is taken. The tables are built in a loop of one traced add, as
    _table_build_body does, and the window step's four doublings in a
    loop of one, as _scalar_mul_fn does."""
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from kzg_tpu.field.pallas_kernels import (
        _const_spec, lazy_mul_tile, mont_mul_tile, mont_sqr_tile)
    from kzg_tpu_torch import convert
    from kzg_tpu_torch.experiments import exp_addcost

    pg = pallas_g1
    spec, D, W, L, LL = fp.SPEC, EXP_DEPTH, 64, 24, pallas_g1.LL
    U32 = jnp.uint32
    csts = pg._cst()[:5]
    mod_t, npr_t = pg._consts()
    mod_c, npr_c = mod_t[:, :1], npr_t[:, :1]

    def pts_of(seed, skip):
        return [np.ascontiguousarray(convert.words_to_ref(c).T)
                for c in exp_addcost.inputs(W, "cpu", seed, skip)]

    def loop(body, init, n=D):
        return lax.fori_loop(0, n, lambda _, p: body(p), init)

    def seven(M, x, y, z):                      # exp_bisect.py:67-75
        a, b, c = M(x, y), M(y, z), M(z, x)
        d, e = M(a, b), M(b, c)
        return M(d, e), M(e, a), c

    def table_of(add, base):                    # pallas_g1.py:413-426
        tbl = tuple(jnp.zeros((8,) + c.shape, c.dtype).at[0].set(c)
                    for c in base)

        def step(k, t):
            nxt = add(tuple(c[k - 1] for c in t), base)
            return tuple(c.at[k].set(v) for c, v in zip(t, nxt))

        return lax.fori_loop(1, 8, step, tbl)

    def lazy_chain(crefs, body, px, py, pz, table=False):
        """to_ext, `D` applications of body(lz, p, tbl), from_ext: the
        chain_kernel of exp_lazyops.py:62-85 (and exp_calib's projdbl)."""
        lz, cin, cout, one = pg._kernel_ctx(crefs)
        p = tuple(pg.to_ext(lz, cin, c) for c in (px, py, pz))
        tbl = None
        if table:                               # exp_lazyops.py:135-137
            tbl = table_of(lambda a, b: pg.proj_add(lz, a, b),
                           pg.jac_to_proj(lz, one, p))
        out = loop(lambda q: body(lz, q, tbl), p)
        return tuple(pg.from_ext(lz, cout, c) for c in out)

    def lazy_double(lz, p, _):
        return pg.proj_double(lz, p)

    def lazy_add(lz, p, _):                     # exp_lazyops.py:94-95
        return pg.proj_add(lz, p, (p[1], p[0], p[2]))

    def lazy_wstep(lz, p, tbl):                 # exp_lazyops.py:99-105
        q = loop(lambda a: pg.proj_double(lz, a), p, 4)
        dig = jnp.full((W,), 5, dtype=jnp.int32)
        return pg._apply_digit(lz, q, *tbl, dig)

    def mulref(kind):                           # exp_lazyops.py:155-177
        def body(lz, p, _):
            modx, nprx, km = lz[:3]
            x, y, z = p

            def M(a, b):
                return lazy_mul_tile(modx, nprx, a, b)

            if kind == "indep":
                outs = [M(x, y), M(y, z), M(z, x), M(x, x),
                        M(y, y), M(z, z), M(x, z), M(y, x)]
                return (outs[0], outs[1], outs[2])
            t0, t1, t2 = M(y, y), M(y, z), M(z, z)
            a, b = M(t2, t0), M(t1, t2)
            c = M(a, b)
            d = M(c, t0)
            return (c, d, M(d, x))

        return body

    def lazy_jit(body, table=False):
        return jax.jit(lambda *v: lazy_chain(v[:5], body, *v[5:], table))

    bspec = pl.BlockSpec((L, W), lambda i: (0, i), memory_space=pltpu.VMEM)

    def lazy_pallas(body):
        """A lazy chain through exp_lazyops' chain_kernel shape."""
        def kernel(mr, nr, cir, cor, oner, px, py, pz, ox, oy, oz):
            ox[:], oy[:], oz[:] = lazy_chain(
                (mr, nr, cir, cor, oner), body, px[:], py[:], pz[:])

        return pl.pallas_call(
            kernel, grid=(1,), in_specs=[_const_spec(LL)] * 5 + [bspec] * 3,
            out_specs=(bspec,) * 3,
            out_shape=tuple(jax.ShapeDtypeStruct((L, W), U32)
                            for _ in range(3)), interpret=True)

    def jac_chain(body, px, py, pz, table=False):
        """`D` applications of body(p, sel) on canonical Jacobian words:
        exp_pointops.py:56-81; the window step's table (:112-125)."""
        p = (px, py, pz)
        sel = None
        if table:
            tbl = table_of(
                lambda a, b: pg.point_add_tile(mod_c, npr_c, a, b), p)
            sel = tuple(c[3] for c in tbl)
        return loop(lambda q: body(q, sel), p)

    def jac_double(p, _):
        return pg.point_double_tile(mod_c, npr_c, p)

    def jac_add(p, _):
        return pg.point_add_tile(mod_c, npr_c, p, (p[1], p[0], p[2]))

    def jac_wstep(p, sel):
        q = loop(lambda a: pg.point_double_tile(mod_c, npr_c, a), p, 4)
        return pg.point_add_tile(mod_c, npr_c, q, sel)

    def chain_pallas(step):
        """x <- step(x) `D` times on (24, W) through the shape of
        exp_pointops' mul_chain and exp_width's serial8."""
        def kernel(mod_ref, npr_ref, a_ref, out_ref):
            mod, npr = mod_ref[:, :1], npr_ref[:, :1]
            out_ref[:] = loop(lambda x: step(mod, npr, x), a_ref[:])

        return pl.pallas_call(
            kernel, grid=(1,), in_specs=[_const_spec(L)] * 2 + [bspec],
            out_specs=bspec, out_shape=jax.ShapeDtypeStruct((L, W), U32),
            interpret=True)

    lazy_dbl = lazy_jit(lazy_double)

    # X3: exp_calib's points (seed 3 after its 64 values); projdbl
    # through its pl.pallas_call (exp_calib.py:114-129)
    pts = pts_of(3, 64)
    put("exp_point:calib:projdbl", lazy_pallas(lazy_double)(
        *csts, *(jnp.asarray(c) for c in pts)), *pts, D)

    # X7: exp_bisect's points; transp through its pl.pallas_call
    # (exp_bisect.py:80-135): tuple3 on 25 rows with the script's
    # zero-padded modulus and n'
    def padded(limbs_np, rows):
        out = np.zeros((rows, 128), np.uint32)
        out[:24] = np.asarray(limbs_np, np.uint32)[:, None]
        return jnp.asarray(out)

    b25 = pl.BlockSpec((LL, W), lambda i: (0, i), memory_space=pltpu.VMEM)

    def transp_kernel(mod_ref, npr_ref, px, py, pz, ox, oy, oz):
        mod, npr = mod_ref[:, :1], npr_ref[:, :1]
        ox[:], oy[:], oz[:] = loop(lambda p: seven(
            lambda a, b: lazy_mul_tile(mod, npr, a, b), *p),
            (px[:], py[:], pz[:]))

    transp = pl.pallas_call(
        transp_kernel, grid=(1,), in_specs=[_const_spec(LL)] * 2 + [b25] * 3,
        out_specs=(b25,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((LL, W), U32)
                        for _ in range(3)), interpret=True)
    p25 = [jnp.pad(jnp.asarray(c), ((0, LL - L), (0, 0))) for c in pts]
    put("exp_point:bisect:transp", transp(
        padded(spec.mod_limbs, LL), padded(spec.nprime_limbs, LL), *p25),
        *pts, D)

    def bisect_ctx(crefs, px, py, pz, conv):
        lz, cin, cout, _ = pg._kernel_ctx(crefs)
        modx, nprx = lz[:2]

        def M(a, b):
            return lazy_mul_tile(modx, nprx, a, b)

        if conv:
            p = tuple(pg.to_ext(lz, cin, c) for c in (px, py, pz))
        else:
            p = tuple(jnp.pad(c, ((0, LL - L), (0, 0)))
                      for c in (px, py, pz))
        out = loop(lambda q: seven(M, *q), p)
        if conv:
            return tuple(pg.from_ext(lz, cout, c) for c in out)
        return tuple(c[:L] for c in out)

    for kind in ("ctx", "conv"):
        fn = jax.jit(lambda *v, conv=kind == "conv": bisect_ctx(
            v[:5], *v[5:], conv))
        put(f"exp_point:bisect:{kind}",
            fn(*csts, *(jnp.asarray(c) for c in pts)), *pts, D)

    # X8: exp_width's points (seed 3); serial8 through its pl.pallas_call
    # (exp_width.py:61-85), projdbl under jit
    pts = pts_of(3, 0)

    def eight_squares(mod, npr, x):
        for _ in range(8):
            x = mont_mul_tile(mod, npr, x, x)
        return x

    put("exp_point:width:serial8", chain_pallas(eight_squares)(
        mod_t, npr_t, jnp.asarray(pts[0])), pts[0], D)
    put("exp_point:width:projdbl",
        lazy_dbl(*csts, *(jnp.asarray(c) for c in pts)), *pts, D)

    # X9: exp_pointops' points (seed 9); mul_chain through its
    # pl.pallas_call (exp_pointops.py:152-166), the rest under jit
    pts = pts_of(9, 0)
    put("exp_point:pointops:mul", chain_pallas(
        lambda mod, npr, x: mont_mul_tile(mod, npr, x, x))(
        mod_t, npr_t, jnp.asarray(pts[0])), pts[0], D)
    sqr = jax.jit(lambda x: loop(lambda v: mont_sqr_tile(mod_c, npr_c, v), x))
    put("exp_point:pointops:sqr", sqr(jnp.asarray(pts[0])), pts[0], D)
    for name, body, table in (("double", jac_double, False),
                              ("add", jac_add, False),
                              ("wstep", jac_wstep, True)):
        fn = jax.jit(lambda *v, body=body, table=table: jac_chain(
            body, *v, table))
        put(f"exp_point:pointops:{name}",
            fn(*(jnp.asarray(c) for c in pts)), *pts, D)

    # X10: exp_lazyops' points (seed 9); mulref chain through its
    # pl.pallas_call (exp_lazyops.py:180-203), the rest under jit but the
    # window step, op by op: its jit compiled for over an hour on the CPU,
    # op by op it takes about 3 minutes (the same integers)
    put("exp_point:lazyops:mulref_chain", lazy_pallas(mulref("chain"))(
        *csts, *(jnp.asarray(c) for c in pts)), *pts, D)
    for name, fn in (("proj_double", lazy_dbl),
                     ("proj_add", lazy_jit(lazy_add)),
                     ("mulref_indep", lazy_jit(mulref("indep")))):
        put(f"exp_point:lazyops:{name}",
            fn(*csts, *(jnp.asarray(c) for c in pts)), *pts, D)
    with jax.disable_jit():
        put("exp_point:lazyops:wstep", tuple(np.asarray(c) for c in lazy_chain(
            csts, lazy_wstep, *(jnp.asarray(c) for c in pts), True)), *pts, D)


GROUPS = {"fft": record_fft, "g1": record_g1, "fk20": record_fk20,
          "g1_add": record_g1_add, "msm": record_msm, "das": record_das,
          "field": record_field, "poly": record_poly,
          "recovery": record_recovery, "proofs": record_proofs,
          "verify": record_verify, "verify_batch": record_verify_batch,
          "eth": record_eth, "fft_g1_generic": record_fft_g1_generic,
          "persist": record_persist, "parallel": record_parallel,
          "parallel_g1": record_parallel_g1, "exp_field": record_exp_field,
          "exp_chain": record_exp_chain, "exp_point": record_exp_point}


def main(names) -> None:
    unknown = set(names) - set(GROUPS)
    if unknown:
        raise SystemExit(f"unknown groups {sorted(unknown)}; "
                         f"choose from {sorted(GROUPS)}")
    out = {}
    if names and os.path.exists(ph.REFERENCE_FILE):
        with np.load(ph.REFERENCE_FILE) as f:
            out = {k: f[k] for k in f.files}
    t0 = time.time()

    def put(key, value, *inputs):
        if isinstance(value, tuple):        # a point batch
            for c, a in zip("xyz", value):
                out[f"{key}:{c}"] = np.asarray(a)
        else:
            out[key] = np.asarray(value)
        out[key + ":inputs"] = np.asarray(ph.inputs_hash(*inputs))
        np.savez_compressed(ph.REFERENCE_FILE, **out)   # keep what is done
        print(f"[{time.time() - t0:7.1f} s] {key}", flush=True)

    for name in names or GROUPS:
        GROUPS[name](put)
    np.savez_compressed(ph.REFERENCE_FILE, **out)
    print(f"wrote {ph.REFERENCE_FILE} ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1:])
