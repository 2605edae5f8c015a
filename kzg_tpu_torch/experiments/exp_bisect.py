"""One 7-product body moved a step at a time toward the ladder's context,
on the card: the counterpart of scripts/exp_bisect.py (its TPU kernel
`variant(kind)`).

    python3 -m kzg_tpu_torch.experiments.exp_bisect [--device cpu]
        [--depth D] [--lanes B]

One launch runs DEPTH = 64 iterations in each of 2048 lanes of
a=M(x,y) b=M(y,z) c=M(z,x) d=M(a,b) e=M(b,c) f=M(d,e) g=M(e,a), carry
(f, g, c), M the 13-word lazy product (REDC over 2^416), in four
contexts:
  base    x = y = z = exp_ab_mul's 64 values tiled (`exp_tuple_chain`
          tuple3 on lazy13: X4's lazy13 launch; run() takes exp_ab_mul's
          lazy13 line where it was timed already);
  transp  x, y, z the script's points' three coordinates, read from a
          word-major (3, 12, lanes) stack, the layout of the TPU's pts.x.T
          (transp on lazy13);
  ctx     the same coordinates zero-padded, the modulus and n0 read from
          a device-memory context into registers and K m built by six lazy
          doublings at kernel start, the low 12 words stored
          (`exp_ext_body`, ctx);
  conv    the same with to_ext on entry and from_ext on exit (conv).
The inputs are the script's: 64 values of 40 random bytes (numpy seed 3),
then its 2048 points from the same generator, the generator times
rng.integers(1, 2^60), as host Jacobian coordinates. Timed with
utils.benchloop.device_loop (the device held while the host enqueues the
launches; base fed the last one's f). One JSON line a context: ns a
product and `correct` on a few lanes against a Python-int model. On the
card by default; `--device cpu` runs the plain versions at depth 2 on 4
lanes.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import exp_ab_mul, exp_addcost
from . import kernels as ek
from . import point_kernels as pk
from .exp_montmul import word_ints

DEPTH = exp_ab_mul.DEPTH
LANES = exp_ab_mul.LANES
CPU_DEPTH = 2
CPU_LANES = 4
SEED = 3
# the 40-byte values the script draws before its points
SKIP = 64
KINDS = ("base", "transp", "ctx", "conv")
PRODUCTS_AN_ITERATION = 7


def points(lanes: int, device) -> tuple:
    return exp_addcost.inputs(lanes, device, SEED, SKIP)


def word_major(pts) -> torch.Tensor:
    """(x, y, z) of (lanes, 12) words -> their (3, 12, lanes) stack."""
    return torch.stack([c.T for c in pts]).contiguous()


def body_step(body: str, M, p) -> tuple:
    """One iteration of a body on Python ints, M the product."""
    x, y, z = p
    if body == "indep8":
        return M(x, y), M(y, z), M(z, x)
    if body == "dblshape":
        t0, t1, t2 = M(y, y), M(y, z), M(z, z)
        c = M(M(t2, t0), M(t1, t2))
        d = M(c, t0)
        return c, d, M(d, x)
    a, b, c = M(x, y), M(y, z), M(z, x)
    d, e = M(a, b), M(b, c)
    return M(d, e), M(e, a), c


def body_int(body: str, point, depth: int) -> tuple:
    """exp_ext_body's output words for one lane on Python ints, and
    transp's (f, g, c) (its f is the kernel's output)."""
    p = ek.FP.modulus

    def M(a, b):
        return ek.redc_int(a * b, ek.EXT_WORDS)

    raw = body in ("ctx", "transp")
    v = tuple(point) if raw else tuple(M(c, ek.EXT_C_IN) for c in point)
    for _ in range(depth):
        v = body_step(body, M, v)
    if raw:
        return v
    out = []
    for c in v:
        r = M(c, ek.EXT_C_OUT)
        out.append(r - p if r >= p else r)
    return tuple(out)


def check_body_lanes(pts, outs, body: str, depth: int,
                     lanes=pk.CHECK_LANES) -> bool:
    lanes = [i for i in lanes if i < pts[0].shape[0]]
    ins = list(zip(*(word_ints(c, lanes) for c in pts)))
    got = list(zip(*(word_ints(c, lanes) for c in outs)))
    return got == [body_int(body, pt, depth) for pt in ins]


def run(device: str = "cuda", depth: int = DEPTH, lanes: int = LANES,
        base: dict | None = None) -> list:
    """One result a context (module docstring). base: exp_ab_mul's line
    for lazy13 at the same depth and lanes, whose launches are base's;
    None times base here."""
    dev = torch.device(device)
    name = pk.device_name(dev)
    pts = points(lanes, dev)
    stack = word_major(pts)
    out = []
    for kind in KINDS:
        if kind == "base" and base is not None:
            if (base["product"], base["depth"], base["lanes"]) != (
                    "lazy13", depth, lanes):
                raise ValueError(f"exp_bisect: base from {base}")
            sec = base["ns_an_iteration"] * depth / 1e9
            floored, correct = base["floored"], base["correct"]
        elif kind == "base":
            x = exp_ab_mul.inputs(lanes, dev)
            sec, floored, one = exp_ab_mul.time_case(x, "tuple3", "lazy13",
                                                     depth)
            correct = exp_ab_mul.check_lanes(x, one, "lazy13", depth,
                                             lanes=pk.CHECK_LANES)
        elif kind == "transp":
            def step(v):
                return ek.exp_tuple_chain(v, "transp", "lazy13", depth)

            sec, floored, _ = pk.loop_time(step, (stack,))
            f = step(stack).T
            lanes_ = [i for i in pk.CHECK_LANES if i < lanes]
            ins = list(zip(*(word_ints(c, lanes_) for c in pts)))
            correct = word_ints(f, lanes_) == [
                body_int("transp", pt, depth)[0] for pt in ins]
        else:
            def step(x, y, z, kind=kind):
                return ek.exp_ext_body(x, y, z, kind, depth)

            sec, floored, _ = pk.loop_time(step, pts)
            correct = check_body_lanes(pts, step(*pts), kind, depth)
        out.append({"experiment": "exp_bisect", "kind": kind,
                    "depth": depth, "lanes": lanes,
                    "ns_a_product": sec / depth / PRODUCTS_AN_ITERATION
                    * 1e9, "ns_an_iteration": sec / depth * 1e9,
                    "floored": floored, "correct": correct,
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
