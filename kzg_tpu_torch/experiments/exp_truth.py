"""One loop body timed three ways, on the card: the counterpart of
scripts/exp_truth.py (its TPU kernel `build(depth)`).

    python3 -m kzg_tpu_torch.experiments.exp_truth [--device cpu]
        [--depths D0 D1] [--lanes B]

The body is exp_addcost's adds0 (csrc/exp_field_kernels.cu,
`exp_ext_chain`): 8 lazy 13-word products an iteration on three Jacobian
coordinates a lane, to and from the lazy domain around the loop, on the
script's 2048 points. The script asked whether three timings of one
product agree:
  depth difference  single launches at depths 64 and 512, each the best
                    of 3 (CUDA events), the difference over 448 * 8
                    products: every fixed cost of a launch cancels;
  chain=False       utils.benchloop.device_loop at depth 64 on the same
                    inputs each launch;
  chain=True        device_loop at depth 64, each launch fed the last
                    one's x as x = y = z.
One JSON line: ns a product by each, their spread (largest over
smallest), `agree` (a spread below AGREE), `floored`, and `correct` (the
outputs at both depths and the chained step's on a few lanes against a
Python-int model). On the card by default; `--device cpu` runs the plain
versions at depths 2 and 4 on 8 lanes, the host clock in place of CUDA
events.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..utils.benchloop import device_loop
from . import exp_addcost
from . import kernels as ek
from .exp_montmul import word_ints

DEPTHS = (64, 512)
CPU_DEPTHS = (2, 4)
TRIES = 3
# the three rates agree when the largest is within 10 % of the smallest
AGREE = 1.10


def once_s(fn, cuda: bool) -> float:
    """Seconds of one call: CUDA events on the card, else the host
    clock."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 1e3


def run(device: str = "cuda", depths=DEPTHS,
        lanes: int = exp_addcost.LANES) -> dict:
    """The three timings of the body (module docstring)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    pts = exp_addcost.inputs(lanes, dev)
    d0, d1 = depths
    per = exp_addcost.PRODUCTS_AN_ITERATION

    def body(x, y, z, depth=d0):
        return ek.exp_ext_chain(x, y, z, "adds", 0, depth)

    correct, single = True, {}
    for depth in depths:
        out = body(*pts, depth=depth)     # the first launch: warm
        correct &= exp_addcost.check_lanes(pts, out, "adds", 0, depth)
        single[depth] = min(once_s(lambda: body(*pts, depth=depth), cuda)
                            for _ in range(TRIES))
    by_depth = (single[d1] - single[d0]) / ((d1 - d0) * per)

    sec, _, floored_free = device_loop(body, pts, k=4, hold=True)
    free = sec / (d0 * per)

    def step(x):
        return body(x, x, x)[0]

    sec, _, floored_chain = device_loop(step, pts[:1], k=4, chain=True,
                                        hold=True)
    chained = sec / (d0 * per)
    x = pts[0]
    lanes_ok = [i for i in exp_addcost.CHECK_LANES if i < lanes]
    correct &= word_ints(step(x), lanes_ok) == [
        exp_addcost.body_int("adds", 0, (v, v, v), d0)[0]
        for v in word_ints(x, lanes_ok)]
    rates = [by_depth, free, chained]
    spread = max(rates) / min(rates) if min(rates) > 0 else float("inf")
    return {"experiment": "exp_truth", "depths": list(depths),
            "lanes": lanes,
            "single_ms": {str(d): single[d] * 1e3 for d in depths},
            "ns_a_product_by_depth": by_depth * 1e9,
            "ns_a_product_chain_false": free * 1e9,
            "ns_a_product_chain_true": chained * 1e9,
            "spread": spread, "agree": spread < AGREE,
            "floored": floored_free or floored_chain,
            "correct": bool(correct), "device": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--depths", type=int, nargs=2, default=None)
    p.add_argument("--lanes", type=int, default=None)
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    result = run(args.device, tuple(args.depths or
                                    (CPU_DEPTHS if cpu else DEPTHS)),
                 args.lanes or (exp_addcost.CPU_LANES if cpu
                                else exp_addcost.LANES))
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
