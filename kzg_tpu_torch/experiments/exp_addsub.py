"""Chains of the small Fp ops on the card: the counterpart of
scripts/exp_addsub.py (its TPU kernel `timed`).

    python3 -m kzg_tpu_torch.experiments.exp_addsub [--device cpu]
        [--depth D] [--lanes B]

One launch applies one op DEPTH = 256 times in each of 2048 Fp lanes
(csrc/exp_field_kernels.cu, `exp_op_chain`), on the script's inputs: 64
values of 40 random bytes (numpy seed 1) reduced mod p in Montgomery form,
tiled to the lanes. The ops, as the script names them:
  mont_mul(x,c)  x c R^-1 mod p, c the n' words (an integer below R, not
                 below p; field.cuh's product needs only x < p);
  mod_add(x,x)   2x mod p;
  mod_sub(m,x)   p - x, as the TPU's mod_sub(m, x) gives it;
  carry_fold     x + 0 on an add.cc chain of 12 words: a 32-bit word
                 engine carries inside that chain and has no separate
                 fold, and the TPU's carry_fold(x)[:L] of canonical limbs
                 is the identity, so this chain stands in for it;
  geq+where      x >= p ? x : p;
  cond_sub       x >= p ? x - p : x.
Timed with utils.benchloop.device_loop (CUDA events, the slope of 1 to 9
chained launches, the device held while the host issues them); one JSON
line an op: ns an op (all lanes at once), a lane's op, and `correct` on a
few lanes against Python ints. On the card by default; `--device cpu` runs
the plain versions at depth 8 on 64 lanes.
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
DEPTH = 256
LANES = 2048
CPU_DEPTH = 8
CPU_LANES = 64
SEED = 1
CHECK_LANES = (0, 1, 63)


def inputs(lanes: int, device) -> torch.Tensor:
    """The script's 64 values tiled to `lanes` lanes
    (scripts/exp_addsub.py:59-63)."""
    rng = np.random.default_rng(SEED)
    vals = [int.from_bytes(rng.bytes(40), "little") for _ in range(64)]
    av = FP.encode(vals, device)
    return av.repeat(-(-lanes // 64), 1)[:lanes].contiguous()


def op_int(op: str, x: int) -> int:
    """One application of `op` to the raw integer x, on Python ints."""
    m = FP.modulus
    if op == "mont_mul(x,c)":
        return x * FP.nprime * FP.r_inv % m
    if op == "mod_add(x,x)":
        return 2 * x % m
    if op == "mod_sub(m,x)":
        return m - x if x <= m else 2 * m - x
    if op == "carry_fold":
        return x
    if op == "geq+where":
        return x if x >= m else m
    if op == "cond_sub":
        return x - m if x >= m else x
    raise ValueError(op)


def expected(op: str, x: int, depth: int) -> int:
    if op == "mont_mul(x,c)":
        m = FP.modulus
        return x * pow(FP.nprime * FP.r_inv % m, depth, m) % m
    for _ in range(depth):
        x = op_int(op, x)
    return x


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    a = inputs(lanes, dev)
    check = [i for i in CHECK_LANES if i < lanes]
    ai = word_ints(a, check)
    out = []
    for op in ek.OPS:
        def step(x, op=op):
            return ek.exp_op_chain(x, op, depth)

        sec, _, floored = device_loop(step, (a,), k=8, chain=True,
                                      hold=True)
        ok = word_ints(step(a), check) == [expected(op, x, depth)
                                           for x in ai]
        out.append({"experiment": "exp_addsub", "op": op, "depth": depth,
                    "lanes": lanes, "ns_an_op": sec / depth * 1e9,
                    "ns_a_lane_op": sec / depth / lanes * 1e9,
                    "floored": floored, "correct": ok, "device": name})
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
