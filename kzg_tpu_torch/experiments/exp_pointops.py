"""Single point operations chained, on the card: the counterpart of
scripts/exp_pointops.py (its TPU kernels chain_kernel, wstep_kernel_build,
mul_chain and sqr_chain).

    python3 -m kzg_tpu_torch.experiments.exp_pointops [--device cpu]
        [--depth D] [--lanes B]

One launch runs DEPTH = 64 operations in each of 2048 lanes:
  double  the canonical Jacobian double (dbl-2009-l, g1_jac.cuh), 7
          products (csrc/exp_point_kernels.cu, `exp_point_chain`, jac);
  add     p <- p + (p.y, p.x, p.z), the complete Jacobian add with
          point_add_tile's selects, 16 products;
  wstep   4 doubles and the add of 4P0 from a [1..8]P0 table of the
          input point built first by (k+1)P0 = kP0 + P0, 44 products: what
          the script meant (its exp_pointops.py:116 calls
          _table_build_body(mod, npr, tx, ty, tz), which today builds a
          lazy projective table from (lz, tx, ty, tz));
  mul     x <- mont_mul(x, x), field.cuh's mul<12> (`exp_tuple_chain`,
          serial1 on mont12);
  sqr     x <- mont_sqr(x) by the symmetric product (serial1 on sqr12;
          the TPU's mont_sqr_tile is mont_mul_tile(x, x)).
The inputs are the script's 2048 points, the generator times
rng.integers(1, 2^60) (numpy seed 9), as the Jacobian coordinates of a
double-and-add on the host; mul and sqr take their x coordinates. Timed
with utils.benchloop.device_loop (the device held while the host enqueues
the launches; mul and sqr each fed the last one's output). One JSON line a
case: us an op (all lanes at once), ns a product-equivalent, and
`correct` on a few lanes against a Python-int model. On the card by
default; `--device cpu` runs the plain versions at depth 2 on 4 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import exp_ab_mul, exp_addcost
from . import kernels as ek
from . import point_kernels as pk

DEPTH = 64
LANES = 2048
CPU_DEPTH = 2
CPU_LANES = 4
SEED = 9
POINT_CASES = ("double", "add", "wstep")
FIELD_CASES = {"mul": "mont12", "sqr": "sqr12"}


def inputs(lanes: int, device) -> tuple:
    return exp_addcost.inputs(lanes, device, SEED)


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a case (module docstring)."""
    dev = torch.device(device)
    name = pk.device_name(dev)
    pts = inputs(lanes, dev)
    out = []
    for op in POINT_CASES:
        sec, floored, one = pk.time_chain(pts, "jac", op, depth)
        n = pk.PRODUCTS_AN_OP[("jac", op)]
        out.append({"experiment": "exp_pointops", "case": op,
                    "domain": "jac", "depth": depth, "lanes": lanes,
                    "us_an_op": sec / depth * 1e6, "products_an_op": n,
                    "ns_a_product_eq": sec / depth / n * 1e9,
                    "floored": floored,
                    "correct": pk.check_lanes(pts, one, "jac", op, depth),
                    "device": name})
    x = pts[0]
    for case, product in FIELD_CASES.items():
        def step(v, product=product):
            return ek.exp_tuple_chain(v, "serial1", product, depth)

        sec, floored, _ = pk.loop_time(step, (x,), chain=True)
        out.append({"experiment": "exp_pointops", "case": case,
                    "product": product, "depth": depth, "lanes": lanes,
                    "us_an_op": sec / depth * 1e6, "products_an_op": 1,
                    "ns_a_product_eq": sec / depth * 1e9,
                    "floored": floored,
                    "correct": exp_ab_mul.check_lanes(
                        x, step(x), product, depth, "serial1",
                        pk.CHECK_LANES),
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
