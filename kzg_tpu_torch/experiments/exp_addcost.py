"""The cost of extra adds beside the products of a loop body, on the card:
the counterpart of scripts/exp_addcost.py (its TPU kernel `variant`).

    python3 -m kzg_tpu_torch.experiments.exp_addcost [--device cpu]
        [--depth D] [--lanes B]

One launch (csrc/exp_field_kernels.cu, `exp_ext_chain`) takes three
Jacobian coordinates a lane into the 13-word lazy domain (R_ext = 2^416),
runs DEPTH = 64 iterations of a=M(x,y) b=M(y,z) c=M(z,x), then NEXTRA
extra ops c = E((a, b, c)[j % 3], c), then d=M(a,b) e=M(b,c) f=M(d,e)
g=M(e,a) h=M(f,g), carry (f, g, h), M the 13-word lazy product, and
takes the three back to canonical Montgomery words. The script's six
variants:
  adds0, adds4, adds12  E the lazy add (a 13-word add chain);
  subs12                E(a, b) = a + (K m - b), K = 64;
  fold12                E = carry_fold(a + b): the lazy add's code, since
                        on 32-bit words the carry lives in the add chain;
  raw12                 E the add of each 32-bit word, its carry dropped
                        (not field arithmetic: held to a model only).
The inputs are the script's 2048 points, the generator times
rng.integers(1, 2^60) (numpy seed 3), as the Jacobian coordinates of a
double-and-add on the host (the script's windowed multiple on the TPU
gives other Jacobian representatives of the same points). Timed with
utils.benchloop.device_loop on the same inputs each launch (chain=False,
the device held while the host enqueues them). One JSON line a variant: ns
an iteration and a product-equivalent (an iteration over 8), the ns an
extra op costs beside adds0's body, and `correct` on a few lanes against
a Python-int model of the kernel's arithmetic. On the card by default;
`--device cpu` runs the plain versions at depth 4 on 8 lanes.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from ..utils import host_ec
from ..utils.benchloop import device_loop
from . import kernels as ek
from .exp_montmul import word_ints

FP = ek.FP
DEPTH = 64
LANES = 2048
CPU_DEPTH = 4
CPU_LANES = 8
SEED = 3
CHECK_LANES = (0, 1, 63)
PRODUCTS_AN_ITERATION = 8


def jacobian_multiple(k: int) -> tuple:
    """k G (2 <= k < r) as Jacobian (X, Y, Z) ints: left-to-right
    double-and-add from the affine generator, dbl-2009-l and mixed
    madd-2007-bl (a = 0). The sum m G + G never meets G or -G, since
    2 <= m < r - 1."""
    p = FP.modulus
    gx, gy = host_ec.g1_generator()
    x, y, z = gx, gy, 1
    for bit in bin(k)[3:]:
        a, b = x * x % p, y * y % p
        c = b * b % p
        d = 2 * ((x + b) * (x + b) - a - c) % p
        e = 3 * a % p
        x3 = (e * e - 2 * d) % p
        y, z = (e * (d - x3) - 8 * c) % p, 2 * y * z % p
        x = x3
        if bit == "1":
            zz = z * z % p
            h = (gx * zz - x) % p
            hh = h * h % p
            i = 4 * hh % p
            j = h * i % p
            r = 2 * (gy * z * zz - y) % p
            v = x * i % p
            x3 = (r * r - j - 2 * v) % p
            y, z = (r * (v - x3) - 2 * y * j) % p, \
                ((z + h) * (z + h) - zz - hh) % p
            x = x3
    return x, y, z


def script_rng(seed: int = SEED, skip: int = 0):
    """numpy's generator as a script leaves it before it draws its points:
    seeded, and `skip` 40-byte values drawn first (scripts/exp_calib.py
    and exp_bisect.py draw 64 for their product chains)."""
    rng = np.random.default_rng(seed)
    for _ in range(skip):
        rng.bytes(40)
    return rng


@functools.lru_cache(maxsize=None)
def point_ints(lanes: int, seed: int = SEED, skip: int = 0) -> tuple:
    """The first `lanes` of a script's 2048 points (scripts/exp_addcost.py
    :48-53), k G with k = rng.integers(1, 2^60, 2048)[i] from
    script_rng(seed, skip), as Jacobian (X, Y, Z) ints of x, y and z."""
    rng = script_rng(seed, skip)
    ks = [int(k) for k in rng.integers(1, 2**60, LANES)]
    pts = [jacobian_multiple(ks[i % LANES]) for i in range(lanes)]
    return tuple(tuple(pt[c] for pt in pts) for c in range(3))


def inputs(lanes: int, device, seed: int = SEED, skip: int = 0) -> tuple:
    """(x, y, z): the points' coordinates as (lanes, 12) Montgomery
    words."""
    return tuple(FP.encode(list(c), device)
                 for c in point_ints(lanes, seed, skip))


def extra_int(kind: str, a: int, b: int) -> int:
    """One extra op E(a, b) on Python ints, mod 2^416 as the kernel."""
    mask = (1 << (32 * ek.EXT_WORDS)) - 1
    if kind in ("adds", "fold"):
        return (a + b) & mask
    if kind == "subs":
        return (a + ek.EXT_KM - b) & mask
    return ek.raw_add_int(a, b, ek.EXT_WORDS)


def body_int(kind: str, nextra: int, point, depth: int) -> tuple:
    """The kernel's result for one lane on Python ints: to_ext, `depth`
    iterations, from_ext of the three Montgomery coordinates."""
    p = FP.modulus

    def M(a, b):
        return ek.redc_int(a * b, ek.EXT_WORDS)

    def from_ext(v):
        r = M(v, ek.EXT_C_OUT)
        return r - p if r >= p else r

    x, y, z = (M(v, ek.EXT_C_IN) for v in point)
    for _ in range(depth):
        a, b, c = M(x, y), M(y, z), M(z, x)
        for j in range(nextra):
            c = extra_int(kind, (a, b, c)[j % 3], c)
        d, e = M(a, b), M(b, c)
        x, y = M(d, e), M(e, a)
        z = M(x, y)
    return tuple(from_ext(v) for v in (x, y, z))


def check_lanes(pts, outs, kind: str, nextra: int, depth: int,
                lanes=CHECK_LANES) -> bool:
    lanes = [i for i in lanes if i < pts[0].shape[0]]
    ins = list(zip(*(word_ints(c, lanes) for c in pts)))
    got = list(zip(*(word_ints(c, lanes) for c in outs)))
    return got == [body_int(kind, nextra, pt, depth) for pt in ins]


def run(device: str = "cuda", depth: int = DEPTH,
        lanes: int = LANES) -> list:
    """One result a variant (module docstring)."""
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    pts = inputs(lanes, dev)
    out, per_iter, words = [], {}, {}
    for kind, nextra in ek.EXT_CASES:
        def step(x, y, z, kind=kind, nextra=nextra):
            return ek.exp_ext_chain(x, y, z, kind, nextra, depth)

        sec, _, floored = device_loop(step, pts, k=4, hold=True)
        one = step(*pts)
        case = f"{kind}{nextra}"
        per_iter[case] = sec / depth
        words[case] = one
        line = {"experiment": "exp_addcost", "variant": case,
                "depth": depth, "lanes": lanes,
                "ns_an_iteration": per_iter[case] * 1e9,
                "ns_a_product_eq": per_iter[case]
                / PRODUCTS_AN_ITERATION * 1e9,
                "ns_an_extra": None if nextra == 0 else
                (per_iter[case] - per_iter["adds0"]) / nextra * 1e9,
                "floored": floored,
                "correct": check_lanes(pts, one, kind, nextra, depth),
                "device": name}
        if kind == "fold":
            # the same device code as adds12: the same words
            line["equals_adds12"] = all(
                torch.equal(a, b) for a, b in zip(one, words["adds12"]))
            line["correct"] = line["correct"] and line["equals_adds12"]
        out.append(line)
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
