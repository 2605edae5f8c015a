"""The 7-product body with its loop carry held three ways, on the card:
the counterpart of scripts/exp_carry.py (its TPU kernels `make(kind)`).

    python3 -m kzg_tpu_torch.experiments.exp_carry [--device cpu]
        [--depth D] [--lanes B]

One launch runs DEPTH = 64 iterations of 7 canonical Fp products
(field.cuh's mul<12>) in each of 2048 lanes (csrc/exp_field_kernels.cu,
`exp_tuple_chain` on mont12), the carry held as
  tuple3  three values in registers: exp_ab_mul's body on mont12, the
          same launch (run() takes exp_ab_mul's mont12 line where it
          was timed already);
  single  the three values written to one 36-word volatile slice of
          shared memory and read back each iteration (the TPU's one
          (72, W) array);
  serial  one value, x <- M(x, x) seven times an iteration.
The inputs and the timing are exp_ab_mul's (numpy seed 3, 40-byte
values; device_loop, each launch fed the last one's output). One JSON
line a carry: ns an iteration and a product, and `correct` on a few
lanes against a Python-int model. On the card by default; `--device cpu`
runs the plain versions at depth 8 on 64 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import exp_ab_mul

KINDS = ("serial", "tuple3", "single")


def run(device: str = "cuda", depth: int = exp_ab_mul.DEPTH,
        lanes: int = exp_ab_mul.LANES, tuple3: dict | None = None) -> list:
    """One result a carry (module docstring). tuple3: exp_ab_mul's line
    for mont12 at the same depth and lanes, whose launches are tuple3's;
    None times tuple3 here."""
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    x = exp_ab_mul.inputs(lanes, dev)
    out = []
    for kind in KINDS:
        if kind == "tuple3" and tuple3 is not None:
            if (tuple3["product"], tuple3["depth"], tuple3["lanes"]) != (
                    "mont12", depth, lanes):
                raise ValueError(f"exp_carry: tuple3 from {tuple3}")
            sec = tuple3["ns_an_iteration"] * depth / 1e9
            floored, correct = tuple3["floored"], tuple3["correct"]
        else:
            sec, floored, one = exp_ab_mul.time_case(x, kind, "mont12",
                                                     depth)
            correct = exp_ab_mul.check_lanes(x, one, "mont12", depth, kind)
        out.append({
            "experiment": "exp_carry", "carry": kind, "depth": depth,
            "lanes": lanes, "ns_an_iteration": sec / depth * 1e9,
            "ns_a_product": sec / depth
            / exp_ab_mul.PRODUCTS_AN_ITERATION * 1e9,
            "floored": floored, "correct": correct, "device": name})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    depth = args.depth or (exp_ab_mul.CPU_DEPTH if cpu else exp_ab_mul.DEPTH)
    lanes = args.lanes or (exp_ab_mul.CPU_LANES if cpu else exp_ab_mul.LANES)
    results = run(args.device, depth, lanes)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
