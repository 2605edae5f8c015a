#!/usr/bin/env python3
"""Time the verification path's pairing kernels, K-b and K-c, at its 128
lanes for the kzg_tpu_torch tree under --root, on one CUDA card.

    python3 kzg_tpu_torch/tools/pairing_turns.py --root DIR

Prints one JSON line: the card, each call's time (CUDA events, after a
warm-up) and a digest of its output. K-c (`pairing_final_exp`) runs on
128 seeded Fp12 values. K-b runs on 128 lanes of pairs (P, G2) and
(P', Q), P and P' seeded G1 points and Q a fixed G2 point, as the
verification path's two pairs: its lines part (`pairing_lines`) computes
the lines of G2 and Q once (timed alone), and `pairing_miller_eval` uses
them for every lane. Every tree computes the reference's exponent, so
the digests of K-c, and of K-c after K-b, must agree between trees.
To compare versions of `csrc/pairing_kernels.cu` or `csrc/tower.cuh`
(trees with this API), make trees that differ in them and run them in
turns (old, new, new, old) on one card, e.g. against the commit this
tree was made on, PARENT:

    git archive PARENT kzg_tpu_torch | tar -x -C build/turns_old
    for r in build/turns_old . . build/turns_old; do
        python3 kzg_tpu_torch/tools/pairing_turns.py --root $r
    done

Each tree builds its own kernels under DIR/build/kernels.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys

LANES = 128
REPS = 3
SEED = 20241


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="directory holding the kzg_tpu_torch tree to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pairing_turns: no CUDA device", file=sys.stderr)
        return 1
    from kzg_tpu_torch.curve import fp2, g1
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.field import fp
    from kzg_tpu_torch.utils import host_ec

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = random.Random(SEED)
    p = fp.SPEC.modulus
    f = fp.from_int(np.asarray([rng.randrange(p) for _ in range(LANES * 12)],
                               dtype=object).reshape(LANES, 2, 3, 2), dev)
    gen1, gen2 = host_ec.g1_generator(), host_ec.g2_generator()
    pts = [host_ec.g1_mul(gen1, rng.randrange(1, 1 << 64))
           for _ in range(2 * LANES)]
    a1 = g1.from_affine_ints(pts[:LANES], dev)
    b1 = g1.from_affine_ints(pts[LANES:], dev)
    q = host_ec.g2_mul(gen2, rng.randrange(1, 1 << 64))
    qx = fp2.from_int([gen2[0], q[0]], dev)
    qy = fp2.from_int([gen2[1], q[1]], dev)
    off = torch.zeros(LANES, dtype=torch.bool, device=dev)
    lines = pk.pairing_lines(qx, qy)

    def miller():
        return pk.pairing_miller_eval(a1, lines[:1], off, b1, lines[1:], off)

    out = {"card": card, "root": args.root, "lanes": LANES,
           "pairing_lines_ms": cuda_ms(lambda: pk.pairing_lines(qx, qy),
                                       REPS),
           "pairing_final_exp ms": cuda_ms(lambda: pk.pairing_final_exp(f),
                                           REPS),
           "pairing_final_exp digest": digest(pk.pairing_final_exp(f)[0]),
           "pairing_miller_eval ms": cuda_ms(miller, REPS),
           "pairing_miller_eval then final_exp digest": digest(
               pk.pairing_final_exp(miller())[0])}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
