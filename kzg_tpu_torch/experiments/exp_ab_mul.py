"""The 7-product body with a canonical product against lazy ones, on the
card: the counterpart of scripts/exp_ab_mul.py (its TPU kernel `run`).

    python3 -m kzg_tpu_torch.experiments.exp_ab_mul [--device cpu]
        [--depth D] [--lanes B]

One launch runs DEPTH = 64 iterations in each of 2048 lanes of
a=M(x,y) b=M(y,z) c=M(z,x) d=M(a,b) e=M(b,c) f=M(d,e) g=M(e,a), carry
(f, g, c), from x = y = z = the input (csrc/exp_field_kernels.cu,
`exp_tuple_chain`, body tuple3), for each product M:
  mont12  field.cuh's canonical mul<12> (mont_mul_tile at 24 limbs);
  lazy12  REDC over 2^384 with no final conditional subtraction
          (lazy_mul_tile at 24 rows);
  lazy13  the same over 2^416, one headroom word (25 rows);
  lazy16  the same over 2^512 (32 rows).
The inputs are the script's: 64 values of 40 random bytes (numpy seed 3)
in Montgomery form, tiled to the lanes. Timed with
utils.benchloop.device_loop (CUDA events, the slope of 1 to 5 launches,
each fed the last one's f, the device held while the host enqueues them);
one JSON line a product: ns a product (all lanes at once) and an
iteration, and `correct` on a few lanes against a Python-int model of the
body. On the card by default; `--device cpu` runs the plain versions at
depth 8 on 64 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..utils.benchloop import device_loop
from . import kernels as ek
from .exp_montmul import word_ints

FP = ek.FP
DEPTH = 64
LANES = 2048
CPU_DEPTH = 8
CPU_LANES = 64
SEED = 3
CHECK_LANES = (0, 1, 63)
PRODUCTS_AN_ITERATION = 7


def inputs(lanes: int, device) -> torch.Tensor:
    """The script's 64 values tiled to `lanes` lanes
    (scripts/exp_ab_mul.py:39-44)."""
    rng = np.random.default_rng(SEED)
    vals = [int.from_bytes(rng.bytes(40), "little") for _ in range(64)]
    av = FP.encode(vals, device)
    return av.repeat(-(-lanes // 64), 1)[:lanes].contiguous()


def product_int(product: str, a: int, b: int) -> int:
    """One product M(a, b) on Python ints, as the kernel computes it."""
    n = ek.PRODUCT_WORDS[product]
    r = ek.redc_int(a * b, n)
    if product in ("mont12", "sqr12"):
        r = r - FP.modulus if r >= FP.modulus else r
    return r


def body_int(product: str, x: int, depth: int, body: str = "tuple3") -> int:
    """The kernel's result for one lane on Python ints: `depth`
    iterations from x = y = z = the input (or of a serial body), f stored
    as 12 words."""
    def M(a, b):
        return product_int(product, a, b)

    if body in ek.SERIAL_STEPS:
        for _ in range(ek.SERIAL_STEPS[body] * depth):
            x = M(x, x)
    else:
        y = z = x
        for _ in range(depth):
            a, b, c = M(x, y), M(y, z), M(z, x)
            d, e = M(a, b), M(b, c)
            x, y, z = M(d, e), M(e, a), c
    return x % FP.r


def check_lanes(x, out, product: str, depth: int, body: str = "tuple3",
                lanes=CHECK_LANES) -> bool:
    lanes = [i for i in lanes if i < x.shape[0]]
    return word_ints(out, lanes) == [body_int(product, v, depth, body)
                                     for v in word_ints(x, lanes)]


def time_case(x, body: str, product: str, depth: int):
    """(seconds a launch, floored, the output of one launch)."""
    def step(v):
        return ek.exp_tuple_chain(v, body, product, depth)

    sec, _, floored = device_loop(step, (x,), k=4, chain=True, hold=True)
    return sec, floored, step(x)


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a product (module docstring)."""
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    x = inputs(lanes, dev)
    out = []
    for product in ek.PRODUCTS:
        sec, floored, one = time_case(x, "tuple3", product, depth)
        out.append({
            "experiment": "exp_ab_mul", "product": product,
            "words": ek.PRODUCT_WORDS[product], "depth": depth,
            "lanes": lanes,
            "ns_a_product": sec / depth / PRODUCTS_AN_ITERATION * 1e9,
            "ns_an_iteration": sec / depth * 1e9, "floored": floored,
            "correct": check_lanes(x, one, product, depth),
            "device": name})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    results = run(args.device, args.depth or (CPU_DEPTH if cpu else DEPTH),
                  args.lanes or (CPU_LANES if cpu else LANES))
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
