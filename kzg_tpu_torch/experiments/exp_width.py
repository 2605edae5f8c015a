"""Whether more threads a block hide a point chain's latency, on the card:
the counterpart of scripts/exp_width.py (its TPU kernels serial8 and
projdbl at several blocks, and butterfly_glv_pallas at two).

    python3 -m kzg_tpu_torch.experiments.exp_width [--device cpu]
        [--depth D] [--lanes B]

On 2048 lanes, DEPTH = 64 steps:
  serial8   x <- mont_mul(x, x) eight times a step, field.cuh's mul<12>,
            256 threads a block as the script's block (`exp_tuple_chain`,
            serial8, on the points' x coordinates);
  projdbl   the lazy RCB double (`exp_point_chain`, lazy) at 64, 256, 512
            and 1024 threads a block, and the ladder domain's (g1.cuh's
            canonical RCB formulas, the ones K3 and g1_fft_stage run) at
            the same blocks;
  glv       K4, `g1_glv_butterfly`, at its own 64 threads only, on the
            points with glv.twiddle_digits of the script's scalars: K4
            keeps a lane's [1..8]P table in shared memory, 73,728 bytes a
            64-thread block (csrc/g1_kernels.cu), so a block of 512
            threads would need 589,824 bytes and one of 1024 1,179,648, over
            the 232,448 a block may take; K4 has no block argument.
Each line gives ms a launch, the SMs it uses (one block an SM: lanes over
threads, rounded up), warps a sub-partition (threads a block over 32 warp
lanes and 4 sub-partitions) and SM-ns a lane-op (ms x SMs over lanes x
steps; the figure that falls where more resident warps hide latency).
The points are the script's 2048 (numpy seed 3), as exp_addcost's, and
its scalars after them. Timed with utils.benchloop.device_loop (the device
held while the host enqueues the launches; serial8 fed the last one's
output). `correct` on a few lanes against Python-int models (glv against
K4's plain version), the ladder's words equal to the lazy ones. On the
card by default; `--device cpu` runs the plain versions at depth 2 on 4
lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import exp_ab_mul, exp_addcost, exp_calib
from . import kernels as ek
from . import point_kernels as pk

DEPTH = exp_ab_mul.DEPTH
LANES = exp_ab_mul.LANES
CPU_DEPTH = 2
CPU_LANES = 4
SEED = 3
SERIAL8_THREADS = 256
GLV_THREADS = 64
# shared memory of one K4 block (csrc/g1_kernels.cu: kSmem = 64 threads x
# 8 entries x 36 words x 4 bytes) and the most a block may take on Hopper
GLV_SMEM_BYTES = 73_728
BLOCK_SMEM_LIMIT = 232_448


def shape(ms: float, threads: int, lanes: int, steps: int) -> dict:
    sms = -(-lanes // threads)
    return {"ms": ms, "threads": threads, "sms_used": sms,
            "warps_a_sub_partition": threads / 32 / 4,
            "sm_ns_a_lane_op": ms * 1e6 * sms / (lanes * steps)}


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a case and block (module docstring)."""
    dev = torch.device(device)
    name = pk.device_name(dev)
    pts = exp_addcost.inputs(lanes, dev, SEED)
    x = pts[0]
    out = []

    def step(v):
        return ek.exp_tuple_chain(v, "serial8", "mont12", depth)

    sec, floored, _ = pk.loop_time(step, (x,), chain=True)
    out.append({"experiment": "exp_width", "case": "serial8",
                "depth": depth, "lanes": lanes,
                **shape(sec * 1e3, SERIAL8_THREADS, lanes, 8 * depth),
                "ns_a_product": sec / depth / 8 * 1e9, "floored": floored,
                "correct": exp_ab_mul.check_lanes(
                    x, step(x), "mont12", depth, "serial8", pk.CHECK_LANES),
                "device": name})
    for threads in pk.THREADS:
        words = {}
        for domain in ("lazy", "ladder"):
            sec, floored, one = pk.time_chain(pts, domain, "double", depth,
                                              threads)
            words[domain] = one
            out.append({"experiment": "exp_width", "case": "projdbl",
                        "domain": domain, "depth": depth, "lanes": lanes,
                        **shape(sec * 1e3, threads, lanes, depth),
                        "ns_a_product_eq": sec / depth / 8 * 1e9,
                        "floored": floored,
                        "correct": pk.check_lanes(pts, one, domain,
                                                  "double", depth),
                        "device": name})
        same = all(torch.equal(a, b)
                   for a, b in zip(words["lazy"], words["ladder"]))
        out[-1]["ladder_equals_lazy"] = same
        out[-1]["correct"] = out[-1]["correct"] and same
    g = exp_calib.time_glv(pts, exp_calib.scalars(lanes, SEED, 0), name)
    out.append({"experiment": "exp_width", "case": "glv", "lanes": lanes,
                **g, **shape(g["ms"], GLV_THREADS, lanes, 1),
                "wider_blocks": f"none: K4's [1..8]P tables take "
                f"{GLV_SMEM_BYTES} bytes of shared memory a "
                f"{GLV_THREADS}-thread block, {GLV_SMEM_BYTES * 8} at 512 "
                f"threads and {GLV_SMEM_BYTES * 16} at 1024, over the "
                f"{BLOCK_SMEM_LIMIT} a block may take"})
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
