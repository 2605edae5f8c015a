#!/usr/bin/env python3
"""Count the device records torch.profiler keeps of a fixed set of launches
as the process ages under load, with and without a ballast of empty spin
launches around them, on one CUDA card.

    python3 kzg_tpu_torch/tools/trace_loss.py [--probes 12] [--gap 20]

Each probe traces 20 `neg_`, 5 `mont_mul` (the port's K1), one 1 ms spin
and 20 `sqrt_` launches, first alone, then behind and ahead of --ballast
`fill_` launches. Between probes the card runs float32 matrix products
and K1 launches for --gap seconds. Prints one JSON line a probe: the
process's age and the records the trace kept of each group. A trace that
keeps fewer `neg_` records than it launched lost records at its start;
chip_smoke.py's traces carry a ballast for that reason.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", type=int, default=12)
    ap.add_argument("--gap", type=float, default=20.0)
    ap.add_argument("--ballast", type=int, default=64)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kzg_tpu_torch.field import fr
    from kzg_tpu_torch.field import kernels as fk

    if not torch.cuda.is_available():
        print("trace_loss: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.time()
    spec = fr.SPEC
    a = fr.from_int(list(range(3, 3 + 8192)), "cuda")
    one = spec.words([1], "cuda")[0]
    y = torch.ones(1 << 16, device="cuda")
    z = torch.zeros(1 << 10, device="cuda")
    m = torch.randn(4096, 4096, device="cuda")
    fk.mont_mul(spec, a, one)
    torch.cuda.synchronize()

    def probe(ballast: int) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ballast):
                z.fill_(1)
            torch.cuda.synchronize()
            for _ in range(20):
                y.neg_()
            for _ in range(5):
                fk.mont_mul(spec, a, one)
            torch.cuda._sleep(2_000_000)
            for _ in range(20):
                y.sqrt_()
            torch.cuda.synchronize()
            for _ in range(ballast):
                z.fill_(2)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]

        def kept(key):
            return sum(key in n.lower() for n in names)

        return {"age_s": round(time.time() - t0, 1), "ballast": ballast,
                "neg": kept("neg"), "mont_mul": kept("mont_mul"),
                "spin": kept("spin"), "sqrt": kept("sqrt"),
                "fill": kept("fill")}

    for _ in range(args.probes):
        for b in (0, args.ballast):
            print(json.dumps(probe(b)), flush=True)
        start = time.time()
        while time.time() - start < args.gap:
            for _ in range(20):
                m @ m
            for _ in range(50):
                fk.mont_mul(spec, a, a)
            torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
