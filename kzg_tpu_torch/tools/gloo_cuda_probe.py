#!/usr/bin/env python3
"""Which collectives of the sharded paths gloo runs on CUDA tensors
itself, without the host staging of kzg_tpu_torch/parallel/mesh.py:

    for r in 0 1; do python3 -m kzg_tpu_torch.tools.gloo_cuda_probe $r 2 \\
        STORE NAME & done; wait

Each rank joins a gloo group of WORLD ranks (every rank on cuda:0) and
calls one collective, NAME (batch_isend_irecv, all_to_all_single or
all_gather), on CUDA tensors, and checks the result against the staged
one. Rank 0 prints one JSON line: the outcome ("ok", "wrong" or the
error's first line). A collective that gloo cannot run on device memory
may abort the process instead (gloo's TCP transport writes from the
pointer it is given), so each collective gets processes of its own.
"""

from __future__ import annotations

import datetime
import json
import sys


def main() -> int:
    rank, world, store, name = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    import torch
    import torch.distributed as dist

    from kzg_tpu_torch.parallel import mesh as M

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    group = dist.group.WORLD
    x = (torch.arange(world * 4, dtype=torch.int32) + 100 * rank).cuda()
    peer = rank ^ 1

    def p2p(t):
        out = torch.empty_like(t)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, peer, group),
                dist.P2POp(dist.irecv, out, peer, group)]):
            r.wait()
        return out

    def a2a(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    def gather(t):
        out = t.new_empty((world,) + tuple(t.shape))
        dist.all_gather(list(out.unbind(0)), t, group=group)
        return out

    staged = {"batch_isend_irecv": lambda: M.ppermute(x, group, 1),
              "all_to_all_single": lambda: M.all_to_all(x, group),
              "all_gather": lambda: M.all_gather(x, group)}[name]()
    fn = {"batch_isend_irecv": p2p, "all_to_all_single": a2a,
          "all_gather": gather}[name]
    try:
        got = fn(x)
        torch.cuda.synchronize()
        outcome = "ok" if torch.equal(got.cpu(), staged.cpu()) else "wrong"
    except (RuntimeError, ValueError, TypeError) as e:
        outcome = str(e).splitlines()[0][:200]
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"gloo_cuda": {name: outcome},
                          "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
