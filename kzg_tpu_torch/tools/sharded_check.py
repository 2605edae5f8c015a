#!/usr/bin/env python3
"""One rank of the sharded paths' check on CUDA cards:

    python3 -m kzg_tpu_torch.tools.sharded_check RANK WORLD STORE OUT BACKEND

joins a process group of WORLD ranks (BACKEND "nccl": one card a rank;
"gloo": every rank on cuda:0, the collectives staged through host memory)
through the file STORE, and runs each sharded path of
kzg_tpu_torch.parallel at the PeerDAS shape with this rank's block:
the Fr FFT at 2^20 both ways, the G1 FFT at 128 points (FK20's width)
and at 4096 both ways, the reverse-bit-order shuffle at 128, the MSM at
4096 points and da_using_fk20_multi_sharded(n = 4096, l = 64), 128
proofs. Rank 0 gathers each result and holds it against the
single-device path on the same card: Fr words equal (canonical), points
equal in affine form. Then it times each path: ms a call on rank 0
(host clock, the card synchronised) and the seconds spent in
collectives. Each rank counts the kernel launches of one call of each
path and writes OUT.RANK.json. Any difference or failure raises, and the
rank exits non-zero. Inputs come from a seed, the same on every rank.
chip_smoke.py (phase 14) starts the ranks; imports torch and the port
only.
"""

from __future__ import annotations

import datetime
import json
import sys
import time

SEED = 20241
SECRET = 1927409816240961209460912649124
REPS = 3
# the PeerDAS shape (EIP-7594): 4096 values a blob, 8192 extended, cells
# of 64, 128 proofs
N, N2, L = 4096, 8192, 64


def random_words(gen, n: int, dev):
    """n canonical Fr words (below 2^252 < r) from a seeded generator: the
    same values on every rank."""
    import torch

    w = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen,
                      dtype=torch.int64)
    w[:, 7] &= 0x0FFFFFFF
    return w.to(torch.int32).to(dev)


def main() -> int:
    rank, world, store, out, backend = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4],
                                        sys.argv[5])
    import torch
    import torch.distributed as dist

    from kzg_tpu_torch.curve import g1
    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.curve.fft_g1 import fft_g1, reverse_bit_order_g1
    from kzg_tpu_torch.curve.msm import lin_comb_g1
    from kzg_tpu_torch.field import kernels as fk
    from kzg_tpu_torch.fk20.multi import FK20MultiSettings
    from kzg_tpu_torch.kzg.setup import insecure_kzg_settings_device
    from kzg_tpu_torch.ntt.domain import FFTSettings
    from kzg_tpu_torch.ntt.fft_fr import fft
    from kzg_tpu_torch.parallel import (
        da_using_fk20_multi_sharded,
        fft_g1_sharded,
        fft_sharded,
        gather_rows,
        lin_comb_g1_sharded,
        make_mesh,
        reverse_bit_order_g1_sharded,
        shard_rows,
    )
    from kzg_tpu_torch.parallel.mesh import CLOCK

    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(world, axes=("elem",), device_type="cuda")
    gen = torch.Generator().manual_seed(SEED)

    fs20 = FFTSettings(20, dev)
    vals = random_words(gen, 1 << 20, dev)
    ks = insecure_kzg_settings_device(SECRET, N, FFTSettings(13, dev))
    fs13 = ks.fs
    pts = g1.mul(g1.generator((N,), dev), random_words(gen, N, dev))
    scalars = random_words(gen, N, dev)
    fks = FK20MultiSettings(ks, N2, L)
    poly = random_words(gen, N, dev)
    local = 2 * fks.k // world
    fks.block_tables(rank * local, (rank + 1) * local)   # setup, untimed

    def affine_equal(a, b) -> bool:
        ax, ay, ai = g1.to_affine(a)
        bx, by, bi = g1.to_affine(b)
        return bool(torch.equal(ai, bi) and torch.equal(ax[~ai], bx[~bi])
                    and torch.equal(ay[~ai], by[~bi]))

    def sharded(fn, x):
        return lambda: fn(shard_rows(x, mesh))

    h128 = type(pts)(*(c[:2 * fks.k] for c in pts))   # FK20's width
    paths = (
        ("fft_2^20", sharded(lambda b: fft_sharded(fs20, b, mesh), vals),
         lambda: fft(fs20, vals), torch.equal),
        ("ifft_2^20", sharded(lambda b: fft_sharded(fs20, b, mesh,
                                                    inverse=True), vals),
         lambda: fft(fs20, vals, inverse=True), torch.equal),
        ("fft_g1_128", sharded(lambda b: fft_g1_sharded(fs13, b, mesh),
                               h128),
         lambda: fft_g1(fs13, h128), affine_equal),
        ("ifft_g1_128", sharded(lambda b: fft_g1_sharded(
            fs13, b, mesh, inverse=True), h128),
         lambda: fft_g1(fs13, h128, inverse=True), affine_equal),
        ("fft_g1_4096", sharded(lambda b: fft_g1_sharded(fs13, b, mesh),
                                pts),
         lambda: fft_g1(fs13, pts), affine_equal),
        ("ifft_g1_4096", sharded(lambda b: fft_g1_sharded(
            fs13, b, mesh, inverse=True), pts),
         lambda: fft_g1(fs13, pts, inverse=True), affine_equal),
        ("brp_g1_128", sharded(lambda b: reverse_bit_order_g1_sharded(
            b, mesh), h128),
         lambda: reverse_bit_order_g1(h128),
         lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))),
        ("msm_4096", lambda: lin_comb_g1_sharded(
            shard_rows(pts, mesh), shard_rows(scalars, mesh), mesh),
         lambda: lin_comb_g1(pts, scalars), affine_equal),
        ("fk20", lambda: da_using_fk20_multi_sharded(fks, poly, mesh),
         lambda: fks.da_using_fk20_multi(poly), affine_equal),
    )
    res = {"rank": rank, "world": world, "backend": backend,
           "device_count": torch.cuda.device_count(), "paths": {}}
    for name, run, single, equal in paths:
        torch.cuda.synchronize()
        dist.barrier()
        fk.reset_launches()
        gk.reset_launches()
        got = run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in {**fk.LAUNCHES, **gk.LAUNCHES}.items()
                    if v}
        full = got if name == "msm_4096" else gather_rows(got, mesh)
        same = None
        if rank == 0:
            same = equal(full, single())
            if not same:
                raise RuntimeError(f"{name}: the sharded result differs "
                                   f"from the single-device path")
        dist.barrier()
        CLOCK.reset()
        CLOCK.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / REPS * 1e3
        CLOCK.timed = False
        res["paths"][name] = {
            "launches": launches, "equal": same, "ms": ms,
            "collective_ms": CLOCK.seconds / REPS * 1e3,
            "collectives": {k: v // REPS for k, v in CLOCK.calls.items()}}
    dist.barrier()
    dist.destroy_process_group()
    mods = sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "kzg_tpu.")) or m == "kzg_tpu")
    if mods:
        raise RuntimeError(f"a rank loaded {mods}")
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
