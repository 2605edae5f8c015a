"""Montgomery-product chains on the card, in three variants: the
counterpart of scripts/exp_montmul.py (its TPU kernel `run_variant`).

    python3 -m kzg_tpu_torch.experiments.exp_montmul [--device cpu]
        [--depth D] [--lanes B]

For Fr and Fp, and for each variant (A: field.cuh's CIOS product, B: the
accumulator in shared memory, C: REDC's by-constant passes on the tensor
cores; csrc/exp_field_kernels.cu), one launch computes x <- REDC(x*b)
DEPTH = 256 times in each of 2048 lanes, on the script's inputs: 64 values
of 31 random bytes (numpy seed 42) in Montgomery form, tiled to the lanes,
and b the same 64 values in reverse order. A launch is timed with
utils.benchloop.device_loop (CUDA events, the slope of 1 to 5 chained
launches, the device held while the host issues them) and checked against
Python ints on a few lanes. One JSON line a variant: ns a chain step (all
lanes at once) and a lane's step, and `correct`. On the card by default;
`--device cpu` runs the plain versions at depth 8 on 64 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..field.limbs import FieldSpec
from ..utils.benchloop import device_loop
from . import kernels as ek

DEPTH = 256
LANES = 2048
CPU_DEPTH = 8
CPU_LANES = 64
SEED = 42
CHECK_LANES = (0, 1, 63, 64)


def inputs(spec: FieldSpec, lanes: int, device) -> tuple:
    """(a, b): the script's 64 values tiled to `lanes` lanes, and the same
    values reversed (scripts/exp_montmul.py:219-229)."""
    rng = np.random.default_rng(SEED)
    vals = [int.from_bytes(rng.bytes(31), "little") for _ in range(64)]
    av = spec.encode(vals, device)
    reps = -(-lanes // 64)
    a = av.repeat(reps, 1)[:lanes].contiguous()
    b = av.flip(0).repeat(reps, 1)[:lanes].contiguous()
    return a, b


def word_ints(t: torch.Tensor, lanes) -> list:
    """The raw words of the given lanes as Python ints."""
    rows = t[list(lanes)].cpu().numpy().astype("<i4")
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def expected(spec: FieldSpec, a_int: int, b_int: int, depth: int) -> int:
    """x <- x b R^-1 mod m, `depth` times from a, on Python ints."""
    m = spec.modulus
    return a_int * pow(b_int * spec.r_inv % m, depth, m) % m


def check_lanes(spec: FieldSpec, a, b, out, depth: int) -> bool:
    lanes = [i for i in CHECK_LANES if i < a.shape[0]]
    want = [expected(spec, x, y, depth) for x, y in
            zip(word_ints(a, lanes), word_ints(b, lanes))]
    return word_ints(out, lanes) == want


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a field and variant (module docstring)."""
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    out = []
    for spec in (ek.SPECS["Fr"], ek.SPECS["Fp"]):
        a, b = inputs(spec, lanes, dev)
        for variant in ek.VARIANTS:
            def step(x, spec=spec, b=b, variant=variant):
                return ek.exp_mont_chain(spec, x, b, variant, depth)

            sec, _, floored = device_loop(step, (a,), k=4, chain=True,
                                          hold=True)
            one = step(a)
            out.append({
                "experiment": "exp_montmul", "field": spec.name,
                "variant": variant, "depth": depth, "lanes": lanes,
                "ns_a_step": sec / depth * 1e9,
                "ns_a_lane_step": sec / depth / lanes * 1e9,
                "floored": floored,
                "correct": check_lanes(spec, a, b, one, depth),
                "device": name})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    depth = args.depth or (CPU_DEPTH if cpu else DEPTH)
    lanes = args.lanes or (CPU_LANES if cpu else LANES)
    results = run(args.device, depth, lanes)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
