"""The lazy projective point ops against their raw product content, on the
card: the counterpart of scripts/exp_lazyops.py (its TPU kernels
chain_kernel, wstep_with_table and mulref).

    python3 -m kzg_tpu_torch.experiments.exp_lazyops [--device cpu]
        [--depth D] [--lanes B]

One launch takes three Jacobian coordinates a lane into the 13-word lazy
domain (R_ext = 2^416), runs DEPTH = 64 steps in each of 2048 lanes and
takes them back to canonical Montgomery words:
  proj_double   the complete RCB double, 8 products (csrc/
                exp_point_kernels.cu, `exp_point_chain`, lazy);
  proj_add      p <- p + (p.y, p.x, p.z), the RCB add, 12 products;
  wstep         4 doubles and the add of digit 5 (5P0) from a [1..8]P0
                table built first from jac_to_proj(P0), 44 products;
  mulref_indep  8 products of x, y, z of which the carry reads three
                (`exp_ext_body`, indep8; the script's five others feed
                nothing);
  mulref_chain  8 products in proj_double's dependency shape (dblshape).
Each point line also times the ladder domain, g1.cuh's canonical RCB
formulas (the ones K3 and g1_fft_stage run), on the same inputs: its words
equal the lazy domain's. The script unpacks three of _lazy_ctx's four
values (exp_lazyops.py:158); its mulref is written out as it meant, with
lz[:3]. The inputs are the script's 2048 points (numpy seed 9), as
exp_pointops'. Timed with utils.benchloop.device_loop on the same inputs
each launch (the device held while the host enqueues them). One JSON line
a case: us an op, ns a product-equivalent, the ladder's us an op beside
(point ops), and `correct` on a few lanes against a Python-int model (the
point ops: also the ladder's words equal to the lazy ones). On the card by
default; `--device cpu` runs the plain versions at depth 2 on 4 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import exp_bisect, exp_pointops
from . import kernels as ek
from . import point_kernels as pk

DEPTH = exp_pointops.DEPTH
LANES = exp_pointops.LANES
CPU_DEPTH = exp_pointops.CPU_DEPTH
CPU_LANES = exp_pointops.CPU_LANES
POINT_CASES = {"proj_double": "double", "proj_add": "add",
               "wstep": "wstep"}
MULREF_CASES = {"mulref_indep": "indep8", "mulref_chain": "dblshape"}
PRODUCTS_A_MULREF = 8


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a case (module docstring)."""
    dev = torch.device(device)
    name = pk.device_name(dev)
    pts = exp_pointops.inputs(lanes, dev)
    out = []
    for case, op in POINT_CASES.items():
        sec, floored, one = pk.time_chain(pts, "lazy", op, depth)
        lsec, lfloored, lone = pk.time_chain(pts, "ladder", op, depth)
        n = pk.PRODUCTS_AN_OP[("lazy", op)]
        same = all(torch.equal(a, b) for a, b in zip(one, lone))
        out.append({"experiment": "exp_lazyops", "case": case,
                    "domain": "lazy", "depth": depth, "lanes": lanes,
                    "us_an_op": sec / depth * 1e6, "products_an_op": n,
                    "ns_a_product_eq": sec / depth / n * 1e9,
                    "ladder_us_an_op": lsec / depth * 1e6,
                    "floored": floored or lfloored,
                    "ladder_equals_lazy": same,
                    "correct": same and pk.check_lanes(pts, one, "lazy", op,
                                                       depth),
                    "device": name})
    for case, body in MULREF_CASES.items():
        def step(x, y, z, body=body):
            return ek.exp_ext_body(x, y, z, body, depth)

        sec, floored, _ = pk.loop_time(step, pts)
        out.append({"experiment": "exp_lazyops", "case": case,
                    "body": body, "depth": depth, "lanes": lanes,
                    "us_an_op": sec / depth * 1e6,
                    "products_an_op": PRODUCTS_A_MULREF,
                    "ns_a_product_eq": sec / depth / PRODUCTS_A_MULREF
                    * 1e9, "floored": floored,
                    "correct": exp_bisect.check_body_lanes(
                        pts, step(*pts), body, depth),
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
