"""REDC's by-constant passes on the tensor cores: the counterpart of
scripts/exp_mxu_mul.py (its TPU kernel `pallas_hybrid_mul_fn`).

    python3 -m kzg_tpu_torch.experiments.exp_mxu_mul [--device cpu]
        [--widths W ...]

A Montgomery product t = a*b, q = (t mod R) n' mod R, s = (t + q m) / R
has two passes by a constant, q and q*m. Here they run as byte-digit
products by the constants' byte-Toeplitz matrices on mma.sync u8 x u8 ->
s32 (csrc/exp_field_kernels.cu, `exp_tc_mont_mul`), with a*b on the CUDA
cores. At W = 2048, 16384 and 131072 Fp lanes (the script's inputs:
numpy seed 7, values below 2^62) one JSON line each gives ns a lane of
  1. K1 `mont_mul` (field/kernels.py), the live product;
  2. the hybrid product (both passes on the tensor cores), one launch;
  3. the pass x <- x n' mod R alone on the tensor cores (the script's
     pass 3, the MXU by-constant pass);
  4. the same pass on the CUDA cores (the script's pass 2, the VPU one);
then the script's decision (its lines 26-27): adopt the hybrid only if it
beats K1 by more than 1.3x. The script's pass 4, the hybrid written at
the XLA level, computes the same function as the kernel of 2 and has no
separate counterpart. Each line carries `correct`: the W = 256 check of
the pass and the hybrid against Python ints first, then each timed
output on a few lanes against Python ints and the hybrid against K1 on
every lane. Timed with utils.benchloop.device_loop (CUDA events, chained
calls, the slope of 1 to 65, the device held while the host issues
them: at these widths a launch takes less device time than the host
needs to issue it). On the card by default; `--device cpu`
runs the plain versions at W = 256. Nothing here puts the hybrid on a
path of the library.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..field import kernels as fk
from ..utils.benchloop import device_loop
from . import kernels as ek
from .exp_montmul import word_ints

FP = ek.FP
MOD = FP.modulus
WIDTHS = (2048, 16384, 131072)
CPU_WIDTHS = (256,)
W0 = 256
SEED = 7
ADOPT_SPEEDUP = 1.3
CHECK_LANES = (0, 1, 255)


def _draw(rng) -> int:
    v = 1
    for _ in range(6):
        v *= int(rng.integers(0, 1 << 62))
    return v % MOD


def inputs(widths, device) -> tuple:
    """(xs, ys, {W: a}) as the script draws them from one generator: the
    256 correctness pairs (products of six 62-bit draws mod p,
    scripts/exp_mxu_mul.py:286-297), then for each width W values below
    2^62 as raw words (:306-312)."""
    rng = np.random.default_rng(SEED)
    xs = [_draw(rng) for _ in range(W0)]
    ys = [_draw(rng) for _ in range(W0)]
    big = {W: FP.words([int(v) for v in rng.integers(0, 1 << 62, size=W)],
                       device) for W in widths}
    return xs, ys, big


def _redc_int(x: int, y: int) -> int:
    return x * y * FP.r_inv % MOD


def _pass_int(x: int) -> int:
    return x * FP.nprime % FP.r


def run(device: str = "cuda", widths=WIDTHS) -> list:
    """The module docstring's lines, as dicts."""
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    xs, ys, big = inputs(widths, dev)
    a0, b0 = FP.words(xs, dev), FP.words(ys, dev)
    lanes0 = range(W0)
    ok0 = (word_ints(ek.exp_tc_mont_mul(a0, mode="tc_pass"), lanes0)
           == [_pass_int(x) for x in xs]
           and word_ints(ek.exp_tc_mont_mul(a0, b0), lanes0)
           == [_redc_int(x, y) for x, y in zip(xs, ys)])
    out = [{"experiment": "exp_mxu_mul", "check": "W0", "lanes": W0,
            "correct": ok0, "device": name}]
    for W in widths:
        a = big[W]
        lanes = [i for i in CHECK_LANES if i < W]
        ai = word_ints(a, lanes)
        k1 = fk.mont_mul(FP, a, a)
        hyb = ek.exp_tc_mont_mul(a, a)
        redc_ok = (bool(torch.equal(k1, hyb)) and word_ints(hyb, lanes)
                   == [_redc_int(x, x) for x in ai])
        pass_want = [_pass_int(x) for x in ai]
        calls = {
            "mont_mul_K1": (lambda x, a=a: fk.mont_mul(FP, x, a), redc_ok),
            "hybrid": (lambda x, a=a: ek.exp_tc_mont_mul(x, a), redc_ok),
            "tc_pass": (lambda x: ek.exp_tc_mont_mul(x, mode="tc_pass"),
                        word_ints(ek.exp_tc_mont_mul(a, mode="tc_pass"),
                                  lanes) == pass_want),
            "cc_pass": (lambda x: ek.exp_tc_mont_mul(x, mode="cc_pass"),
                        word_ints(ek.exp_tc_mont_mul(a, mode="cc_pass"),
                                  lanes) == pass_want),
        }
        ns = {}
        for metric, (fn, ok) in calls.items():
            sec, _, floored = device_loop(fn, (a,), k=64, chain=True,
                                          hold=True)
            ns[metric] = sec * 1e9 / W
            out.append({"experiment": "exp_mxu_mul", "metric": metric,
                        "lanes": W, "ns_a_lane": ns[metric],
                        "floored": floored, "correct": ok, "device": name})
        speedup = ns["mont_mul_K1"] / ns["hybrid"]
        out.append({"experiment": "exp_mxu_mul", "decision": "hybrid vs K1",
                    "lanes": W, "speedup": speedup,
                    "adopt": speedup > ADOPT_SPEEDUP,
                    "rule": f"adopt only above {ADOPT_SPEEDUP}x",
                    "correct": redc_ok, "device": name})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--widths", type=int, nargs="+", default=None)
    args = p.parse_args(argv)
    widths = tuple(args.widths or (CPU_WIDTHS if args.device == "cpu"
                                   else WIDTHS))
    results = run(args.device, widths)
    for r in results:
        print(json.dumps(r), flush=True)
    return 0 if all(r["correct"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
