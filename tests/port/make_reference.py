#!/usr/bin/env python3
"""Record the JAX package's outputs for the port's tests.

    python tests/port/make_reference.py            # every group, ~30 min
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
sys.path[:0] = [ROOT, HERE]

import conftest  # noqa: E402,F401  (JAX on the CPU, as for the JAX tests)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import port_helpers as ph  # noqa: E402

from kzg_tpu.curve import g1  # noqa: E402
from kzg_tpu.curve import pallas_g1  # noqa: E402
from kzg_tpu.curve.fft_g1 import fft_g1  # noqa: E402
from kzg_tpu.curve.msm import lin_comb_g1, tree_reduce  # noqa: E402
from kzg_tpu.field import fr  # noqa: E402
from kzg_tpu.field.backend import set_field_backend  # noqa: E402
from kzg_tpu.field.pallas_kernels import butterfly_lazy_dif  # noqa: E402
from kzg_tpu.fk20 import FK20MultiSettings  # noqa: E402
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


GROUPS = {"fft": record_fft, "g1": record_g1, "fk20": record_fk20,
          "g1_add": record_g1_add, "msm": record_msm, "das": record_das}


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
        print(f"[{time.time() - t0:7.1f} s] {key}", flush=True)

    for name in names or GROUPS:
        GROUPS[name](put)
    np.savez_compressed(ph.REFERENCE_FILE, **out)
    print(f"wrote {ph.REFERENCE_FILE} ({len(out)} arrays)")


if __name__ == "__main__":
    main(sys.argv[1:])
