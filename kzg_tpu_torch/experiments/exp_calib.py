"""Every layer of the G1 ladder in one process, on the card: the
counterpart of scripts/exp_calib.py (its TPU kernels mulchain and projdbl,
and butterfly_glv_pallas).

    python3 -m kzg_tpu_torch.experiments.exp_calib [--device cpu]
        [--depth D] [--lanes B]

Four lines, timed in one process so that their ratios to mont24 hold
whatever the card's clocks do:
  mont24   DEPTH = 64 iterations of the 7-product body on field.cuh's
           canonical mul<12> in 2048 lanes (`exp_tuple_chain` tuple3 on
           mont12, X4's launch, exp_ab_mul's 64 values): ns a product;
  lazy25   the same on the 13-word lazy product (lazy13);
  projdbl  64 lazy RCB doubles (`exp_point_chain`, lazy) on the script's
           2048 points: ns a product-equivalent, 8 a double;
  glv      K4, `g1_glv_butterfly` (the G1 FFT's radix-2 stage, A +- [d]B)
           with A = B the points and glv.twiddle_digits of the script's
           2048 scalars: ns a product-equivalent, where the products are
           those K4's code runs on each lane's digits (g1.cuh's ladder:
           jac_to_proj, 7 table adds, 4 doubles a window below the top
           nonzero one, an add a nonzero digit and a beta product a
           nonzero phi digit, then A's jac_to_proj and two adds and two
           store_jac), the largest lane's count (the TPU's script divided
           by a fixed 1976).
Each line also gives its ratio to mont24's ns a product. The inputs are
the script's: 64 values of 40 random bytes (numpy seed 3), then from the
same generator the points, the generator times rng.integers(1, 2^60) as
host Jacobian coordinates, then the scalars, 32 random bytes mod r each.
Timed with utils.benchloop.device_loop (the device held while the host
enqueues the launches; the product bodies fed the last one's f). `correct`
on a few lanes: against Python-int models, glv against K4's plain version
on those lanes. On the card by default; `--device cpu` runs the plain
versions at depth 2 on 4 lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..curve import glv
from ..curve import kernels as gk
from ..curve.weierstrass import JacobianPoint
from ..field import fr
from . import exp_ab_mul, exp_addcost, exp_bisect
from . import point_kernels as pk

DEPTH = exp_ab_mul.DEPTH
LANES = exp_ab_mul.LANES
CPU_DEPTH = 2
CPU_LANES = 4
LAYER_PRODUCTS = {"mont24": "mont12", "lazy25": "lazy13"}


def scalars(lanes: int, seed: int = exp_bisect.SEED,
            skip: int = exp_bisect.SKIP) -> list:
    """The script's scalars, drawn after its points (exp_calib.py:158-159,
    exp_width.py:124-125)."""
    rng = exp_addcost.script_rng(seed, skip)
    rng.integers(1, 2**60, exp_addcost.LANES)
    r = fr.SPEC.modulus
    return [int.from_bytes(rng.bytes(32), "little") % r
            for _ in range(exp_addcost.LANES)][:lanes]


def glv_products(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """The Fp products K4 runs on each lane (module docstring)."""
    nz = (d1 != 0) | (d2 != 0)
    top = np.where(nz.any(1), nz.shape[1] - 1 - np.argmax(nz[:, ::-1], 1),
                   -1)
    return (3 + 7 * 12 + 32 * np.maximum(top, 0)
            + 12 * (d1 != 0).sum(1) + 13 * (d2 != 0).sum(1)
            + 3 + 2 * (12 + 3))


def time_glv(pts, sc, name: str) -> dict:
    """The glv line's numbers: K4 on all lanes with A = B the points,
    held on CHECK_LANES against its plain version."""
    d1, d2 = (torch.from_numpy(np.ascontiguousarray(d)).to(pts[0].device)
              for d in glv.twiddle_digits(sc))
    prods = glv_products(d1.cpu().numpy(), d2.cpu().numpy())
    b = JacobianPoint(*pts)

    def step(x, y, z):
        lo, _ = gk.g1_glv_butterfly(JacobianPoint(x, y, z), b, d1, d2)
        return tuple(lo)

    sec, floored, _ = pk.loop_time(step, pts)
    lo, hi = gk.g1_glv_butterfly(b, b, d1, d2)
    lanes = [i for i in pk.CHECK_LANES if i < pts[0].shape[0]]
    few = JacobianPoint(*(c[lanes].cpu() for c in b))
    want = gk.g1_glv_butterfly_plain(few, few, d1[lanes].cpu(),
                                     d2[lanes].cpu())
    correct = all(torch.equal(g[lanes].cpu(), w) for got, exp in
                  zip((lo, hi), want) for g, w in zip(got, exp))
    most = int(prods.max())
    return {"ms": sec * 1e3, "products_a_lane_max": most,
            "products_a_lane_mean": float(prods.mean()),
            "ns_a_product_eq": sec / most * 1e9, "floored": floored,
            "correct": correct, "device": name}


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a layer (module docstring)."""
    dev = torch.device(device)
    name = pk.device_name(dev)
    x = exp_ab_mul.inputs(lanes, dev)
    out = []
    for layer, product in LAYER_PRODUCTS.items():
        sec, floored, one = exp_ab_mul.time_case(x, "tuple3", product, depth)
        out.append({"experiment": "exp_calib", "layer": layer,
                    "product": product, "depth": depth, "lanes": lanes,
                    "ns_a_product_eq": sec / depth
                    / exp_ab_mul.PRODUCTS_AN_ITERATION * 1e9,
                    "floored": floored,
                    "correct": exp_ab_mul.check_lanes(
                        x, one, product, depth, lanes=pk.CHECK_LANES),
                    "device": name})
    pts = exp_bisect.points(lanes, dev)
    sec, floored, one = pk.time_chain(pts, "lazy", "double", depth)
    n = pk.PRODUCTS_AN_OP[("lazy", "double")]
    out.append({"experiment": "exp_calib", "layer": "projdbl",
                "depth": depth, "lanes": lanes,
                "ns_a_product_eq": sec / depth / n * 1e9,
                "floored": floored,
                "correct": pk.check_lanes(pts, one, "lazy", "double", depth),
                "device": name})
    out.append({"experiment": "exp_calib", "layer": "glv", "lanes": lanes,
                **time_glv(pts, scalars(lanes), name)})
    base = out[0]["ns_a_product_eq"]
    for line in out:
        line["ratio_to_mont24"] = line["ns_a_product_eq"] / base
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
