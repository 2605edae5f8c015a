#!/usr/bin/env python3
"""Time the Fr FFT at 2^20 on K2's per-stage route and Fr products at
2^20 lanes, for the kzg_tpu_torch tree under --root, on one CUDA card.

    python3 kzg_tpu_torch/tools/field_turns.py --root DIR

The route is brp_permute, a clone, then one `fr_butterfly_stage` launch
a stage (the Fr FFT of the port up to its block kernel). Prints one JSON
line: the card, the transform's time (CUDA events), each stage's time,
K1 (`mont_mul`) at 2^20 lanes, the registers ptxas gave the Fr kernels,
and with --routes the route kernels: `fr_fft_block` at 2^20 and 8192, a
one-lane `fr_pow`, `fr_batch_inv` at 8192 lanes,
`fr_zero_poly_leaves` at 64 leaves and, where the tree has it,
`fr_das_block` (the DAS extension, interleaved) at 1 and 9 blobs of
4096, its call (CUDA events) and each launch's device time (a
torch.profiler trace), and the recoding `fr.scalar_windows_signed` (at
8192 and 36,864 Montgomery scalars) and `butterfly` (2^16 and 2^20
lanes, Fr and Fp), each a call (events) and its device time and device
operations (trace). To compare two versions of a kernel source, make a
second tree that differs in it and run the two in turns (old, new, new,
old) on one card, e.g. this tree's kernels against those of the commit
it was made on, PARENT:

    git archive PARENT kzg_tpu_torch | tar -x -C build/turns_old
    for r in build/turns_old . . build/turns_old; do
        python3 kzg_tpu_torch/tools/field_turns.py --root $r --routes
    done

Each tree builds its own kernels under DIR/build/kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

LOG_N = 20
REPS = 10


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_spans(fn, reps: int) -> list:
    """(name, device ms) of every device activity of `reps` calls of fn,
    from a torch.profiler trace, which may miss some launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, match: str, reps: int) -> tuple:
    """(mean device ms of one launch of the kernel whose name holds
    `match`, launches caught) over `reps` calls of fn."""
    mine = [ms for name, ms in device_spans(fn, reps) if match in name]
    return (sum(mine) / len(mine), len(mine)) if mine else (None, 0)


def call_device_ms(fn, reps: int) -> dict:
    """A call's device time (all its device activity, summed) and its
    device operations, a mean over the calls, from a trace."""
    spans = device_spans(fn, reps)
    return {"device_ms": sum(ms for _, ms in spans) / reps,
            "device_ops": len(spans) / reps,
            "names": sorted({name[:60] for name, _ in spans})}


def timed(fn, reps: int) -> dict:
    """A call's time (CUDA events), then its device time (trace)."""
    return {"call_ms": cuda_ms(fn, reps), **call_device_ms(fn, reps)}


def recoding_and_butterfly(fr, fk, words, dev) -> dict:
    """The recoding in front of the G1 products (`fr.scalar_windows_signed`
    on Montgomery words: K1's from_mont and the recoding in trees before
    the one-launch kernel, one launch after) at 8192 scalars (Toeplitz
    part 2) and 9 x 4096 (a block's nine blobs committed at once), and
    `butterfly` at 2^16 and 2^20 lanes, Fr and Fp, per-lane twiddles:
    each a call (CUDA events) and its device time and operations
    (trace)."""
    import torch

    from kzg_tpu_torch.field import fp

    out = {}
    for n in (8192, 9 * 4096):
        w = words[:n].contiguous()
        out[f"windows_mont_{n}"] = timed(
            lambda w=w: fr.scalar_windows_signed(w), REPS)
    for spec in (fr.SPEC, fp.SPEC):
        N = spec.n_words
        for log_n in (16, LOG_N):
            n = 1 << log_n
            # canonical words below the modulus (the top word < 2^28)
            v = np.random.default_rng(log_n).integers(
                0, 1 << 31, size=(3, n, N), dtype=np.int64)
            v[..., N - 1] &= 0x0FFFFFFF
            a, b, tw = torch.from_numpy(v.astype(np.int32)).to(dev)
            key = f"butterfly_{spec.name}_{log_n}"
            out[key] = timed(lambda: fk.butterfly(spec, a, b, tw), REPS)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--routes", action="store_true",
                    help="also time the route kernels (trees that have "
                    "csrc/fr_route_kernels.cu)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("field_turns: no CUDA device", file=sys.stderr)
        return 1
    from kzg_tpu_torch import build
    from kzg_tpu_torch.field import fr
    from kzg_tpu_torch.field import kernels as fk
    from kzg_tpu_torch.ntt.bitrev import brp_permute
    from kzg_tpu_torch.ntt.domain import FFTSettings

    lib = build.library("fr_kernels")
    with open(build._lib_path("fr_kernels")[:-3] + ".log") as f:
        text = f.read()
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?Used (\d+) registers", text,
        re.S)}
    del lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    log_n = LOG_N
    n = 1 << log_n
    fs = FFTSettings(log_n, dev)
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 31, size=(n, 8), dtype=np.int64)
    words[:, 7] &= 0x0FFFFFFF          # below r: canonical Montgomery words
    x = torch.from_numpy(words.astype(np.int32)).to(dev).reshape(1, n, 8)
    roots = fs.expanded_roots_of_unity

    def stages():
        y = brp_permute(x, axis=-2).clone(memory_format=torch.contiguous_format)
        for s in range(1, log_n + 1):
            fk.fr_butterfly_stage(fr.SPEC, y, roots, s - 1, n >> s)
        return y

    out = {"root": args.root, "card": card,
           "fft_stages_ms": cuda_ms(stages, REPS)}
    y = x.clone()
    out["stage_ms"] = [cuda_ms(lambda s=s: fk.fr_butterfly_stage(
        fr.SPEC, y, roots, s - 1, n >> s), REPS)
        for s in range(1, log_n + 1)]
    a = x.reshape(n, 8)
    out["mont_mul_ms"] = cuda_ms(lambda: fk.mont_mul(fr.SPEC, a, a),
                                 REPS)
    if args.routes:
        blk = fk.fr_fft_block(fr.SPEC, x, roots, n)
        if not torch.equal(blk, stages()):
            raise RuntimeError("fr_fft_block differs from the stage route")
        out["fft_block_ms"] = cuda_ms(
            lambda: fk.fr_fft_block(fr.SPEC, x, roots, n), REPS)
        x13 = x[:, :8192].contiguous()
        out["fft_block_8192_ms"] = cuda_ms(
            lambda: fk.fr_fft_block(fr.SPEC, x13, roots, n), REPS)
        # latency-bound chains: one lane's Fermat ladder (r - 2), the
        # batch inversion of 8192 lanes, 64 leaves of 64 factors
        r = fr.SPEC.modulus
        lane = x[0, :1]
        out["fr_pow_lane_ms"] = cuda_ms(
            lambda: fk.fr_pow(fr.SPEC, lane, r - 2), REPS)
        out["batch_inv_8192_ms"] = cuda_ms(
            lambda: fk.fr_batch_inv(fr.SPEC, x13[0]), REPS)
        idx = np.arange(64 * 64, dtype=np.int32).reshape(64, 64)
        out["leaves_64_ms"] = cuda_ms(lambda: fk.fr_zero_poly_leaves(
            fr.SPEC, roots, idx, idx >= 0), REPS)
        if hasattr(fk, "fr_das_block"):
            fs13 = FFTSettings(13, dev)
            tables = (fs13.reverse_roots_of_unity,
                      fs13.expanded_roots_of_unity)
            for b in (1, 9):
                xb = x[0, :b * 4096].reshape(b, 4096, 8).contiguous()
                fn = (lambda xb=xb: fk.fr_das_block(fr.SPEC, xb, *tables,
                                                    8192, True))
                out[f"das_{b}_call_ms"] = cuda_ms(fn, REPS)
                out[f"das_{b}_launch_ms"] = device_ms(fn, "das_block", REPS)
        out.update(recoding_and_butterfly(fr, fk, x.reshape(n, 8), dev))
    out["registers"] = regs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
