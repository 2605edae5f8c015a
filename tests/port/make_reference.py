#!/usr/bin/env python3
"""Record the JAX package's outputs for the port's tests.

    python tests/port/make_reference.py     # from anywhere; ~20 min on a CPU

Runs kzg_tpu on its CPU "vector" engine, set up as its own tests set it
up (the root conftest.py), on the inputs that port_helpers.py builds, and
writes port_helpers.REFERENCE_FILE. Each record stores a hash of its
inputs beside the outputs. Rerun it only if those inputs change; kzg_tpu
itself is frozen.
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
from kzg_tpu.curve.fft_g1 import fft_g1  # noqa: E402
from kzg_tpu.curve.msm import tree_reduce  # noqa: E402
from kzg_tpu.field import fr  # noqa: E402
from kzg_tpu.fk20 import FK20MultiSettings  # noqa: E402
from kzg_tpu.kzg import KZGSettings, generate_testing_setup  # noqa: E402
from kzg_tpu.ntt import FFTSettings, fft  # noqa: E402


def main() -> None:
    out = {}
    t0 = time.time()

    def put(key, value, *inputs):
        if isinstance(value, tuple):        # a point batch
            for c, a in zip("xyz", value):
                out[f"{key}:{c}"] = np.asarray(a)
        else:
            out[key] = np.asarray(value)
        out[key + ":inputs"] = np.asarray(ph.inputs_hash(*inputs))
        print(f"[{time.time() - t0:7.1f} s] {key}", flush=True)

    for scale in ph.FFT_SCALES:
        vals = fr.from_int(ph.fft_input(scale))
        for inverse in (False, True):
            put(f"fft:{scale}:{int(inverse)}",
                fft(FFTSettings(scale), jnp.asarray(vals), inverse), vals)

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

    # the kzg_env fixture's settings (tests/conftest.py)
    s1, _, a1, a2 = generate_testing_setup(ph.TEST_SECRET, ph.CRS_SIZE)
    ks = KZGSettings(FFTSettings(5), s1, a2, a1)
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

    np.savez_compressed(ph.REFERENCE_FILE, **out)
    print(f"wrote {ph.REFERENCE_FILE} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
