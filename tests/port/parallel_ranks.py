"""One rank of the sharded paths' CPU tests (test_torch_parallel.py):

    python tests/port/parallel_ranks.py RANK 4 STORE OUT

joins a gloo group of 4 ranks through the file STORE, runs every sharded
function of kzg_tpu_torch.parallel on port_helpers' inputs at D = 4 and
D = 2, with each rank holding its block, and rank 0 writes the gathered
outputs ("D4/...", "D2/...") and the checks' outcomes to OUT (an .npz).
Imports torch, numpy and the port only: no JAX.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import port_helpers as ph  # noqa: E402
from kzg_tpu_torch import convert  # noqa: E402
from kzg_tpu_torch.curve import g1  # noqa: E402
from kzg_tpu_torch.curve.fft_g1 import fft_g1  # noqa: E402
from kzg_tpu_torch.curve.weierstrass import JacobianPoint  # noqa: E402
from kzg_tpu_torch.field import fr  # noqa: E402
from kzg_tpu_torch.fk20.multi import FK20MultiSettings  # noqa: E402
from kzg_tpu_torch.kzg.settings import KZGSettings  # noqa: E402
from kzg_tpu_torch.ntt.domain import FFTSettings  # noqa: E402
from kzg_tpu_torch.ntt.fft_fr import fft  # noqa: E402
from kzg_tpu_torch.parallel import (  # noqa: E402
    da_using_fk20_multi_sharded,
    fft_g1_sharded,
    fft_sharded,
    gather_rows,
    lin_comb_g1_sharded,
    make_mesh,
    reverse_bit_order_g1_sharded,
    shard_rows,
)
from kzg_tpu_torch.parallel.mesh import axis_size  # noqa: E402

CPU = ph.CPU


def raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def point_words(p: JacobianPoint) -> np.ndarray:
    return torch.stack(tuple(p)).numpy()


def run(mesh, fks, fs) -> tuple:
    """The sharded cases on the "elem" axis of `mesh` (D ranks) ->
    (arrays, outcomes) of this rank; its elem rank 0's are kept."""
    D = axis_size(mesh, "elem")
    s = mesh.get_local_rank("elem")
    out, ok = {}, {}

    def sharded(fn, x, *args, **kw):
        return gather_rows(fn(shard_rows(x, mesh), *args, **kw), mesh)

    vals = fr.from_int(ph.parallel_fft_input(), CPU)
    ok["rows_round_trip"] = torch.equal(
        gather_rows(shard_rows(vals, mesh), mesh), vals)
    for inverse in (False, True):
        out[f"fft:{int(inverse)}"] = sharded(
            lambda b: fft_sharded(fs, b, mesh, inverse=inverse), vals).numpy()
    # leading batch axes stay whole: two transforms against one device's
    batch = torch.stack((vals, fr.from_int(list(range(ph.PAR_FFT_N)), CPU)))
    ok["fft_batch"] = torch.equal(
        sharded(lambda b: fft_sharded(fs, b, mesh, inverse=True), batch),
        fft(fs, batch, inverse=True))

    _, pts = ph.parallel_g1_case(ph.PAR_G1_N)
    ok["points_round_trip"] = all(torch.equal(a, b) for a, b in zip(
        gather_rows(shard_rows(pts, mesh), mesh), pts))
    for inverse in (False, True):
        out[f"fft_g1:{int(inverse)}"] = point_words(sharded(
            lambda b: fft_g1_sharded(fs, b, mesh, inverse=inverse), pts))
    out["brp_g1"] = point_words(sharded(
        lambda b: reverse_bit_order_g1_sharded(b, mesh), pts))

    for n in ph.PAR_MSM_NS:
        _, mp = ph.parallel_g1_case(n)
        sc = fr.from_int(ph.parallel_msm_scalars(n), CPU)
        res = lin_comb_g1_sharded(shard_rows(mp, mesh), shard_rows(sc, mesh),
                                  mesh)
        # the same point on every rank
        every = gather_rows(JacobianPoint(*(c[None] for c in res)), mesh)
        ok[f"msm_replicated:{n}"] = all(
            torch.equal(c, c[:1].expand_as(c)) for c in every)
        out[f"msm:{n}"] = point_words(res)

    # FK20 on the kzg_env shape: 2k = 8 proofs need local = 8 / D >= D
    poly = fr.from_int(ph.FK20_COEFFS, CPU)
    if D == 2:
        out["fk20"] = point_words(gather_rows(
            da_using_fk20_multi_sharded(fks, poly, mesh), mesh))
    else:
        ok["fk20_small_local_raises"] = raises(
            lambda: da_using_fk20_multi_sharded(fks, poly, mesh))
    ok["fk20_wrong_length_raises"] = raises(
        lambda: da_using_fk20_multi_sharded(fks, poly[:-1], mesh))

    # the reference's ValueErrors: local < D, n not a power of two, n
    # wider than the domain, a length that does not divide D, unequal
    # MSM blocks
    ok["fft_small_local_raises"] = raises(
        lambda: fft_sharded(fs, vals[:1], mesh))
    ok["fft_not_pow2_raises"] = raises(lambda: fft_sharded(
        fs, fr.from_int(list(range(3 * D)), CPU), mesh))
    ok["fft_too_wide_raises"] = raises(lambda: fft_sharded(
        FFTSettings(3, CPU), shard_rows(vals, mesh), mesh))
    ok["g1_small_local_raises"] = raises(lambda: fft_g1_sharded(
        fs, JacobianPoint(*(c[:1] for c in pts)), mesh))
    ok["shard_rows_raises"] = raises(lambda: shard_rows(vals[: D + 1], mesh))
    _, mp = ph.parallel_g1_case(4)
    m = 2 if s == 0 else 1
    ok["msm_unequal_raises"] = raises(lambda: lin_comb_g1_sharded(
        JacobianPoint(*(c[:m] for c in mp)), fr.from_int([1, 2], CPU)[:m],
        mesh))
    return out, ok


def main() -> None:
    """One world of max(PAR_DS) = 4 ranks serves both D: D = 4 on an
    "elem" axis of every rank, then D = 2 on the "elem" axis of a (2, 2)
    ("data", "elem") mesh, run by the ranks of its first data row only
    (the other row's elem group is separate and has nothing to do)."""
    rank, world, store, path = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with torch.inference_mode():    # no autograd bookkeeping per op
            # every rank makes every mesh: making one is collective
            meshes = {4: make_mesh(world, axes=("elem",), device_type=CPU),
                      2: make_mesh(world, axes=("data", "elem"),
                                   shape=(2, 2), device_type=CPU)}
            default = make_mesh(device_type=CPU)
            flat = make_mesh(world, axes=("data", "elem"), shape=(world, 1),
                             device_type=CPU)
            fs = FFTSettings(ph.PAR_SCALE, CPU)
            # the recorded CRS and part-1 tables (the JAX package's, bit
            # for bit); D = 4 only checks arguments, on stand-in tables
            fks = {2: convert.fk20_settings_from_reference(
                FFTSettings(5, CPU),
                ph.reference("crs", ph.TEST_SECRET, ph.CRS_SIZE),
                ph.FK20_N2, 2, ph.reference("fk20:2:tables", ph.TEST_SECRET,
                                            ph.CRS_SIZE, 2)),
                   4: FK20MultiSettings(
                       KZGSettings(FFTSettings(5, CPU),
                                   g1.infinity((ph.CRS_SIZE,), CPU)),
                       ph.FK20_N2, 2, g1.infinity((2, 8), CPU))}
            res = {D: run(meshes[D], fks[D], fs) for D in ph.PAR_DS
                   if D == world or meshes[D].get_local_rank("data") == 0}
            ok = {"default_mesh": default.mesh_dim_names == ("data", "elem")
                  and axis_size(default, "elem") == world
                  and axis_size(default, "data") == 1,
                  "data_axis": axis_size(meshes[2], "data") == 2,
                  "elem_of_one": axis_size(flat, "elem") == 1}
            if rank == 0:   # on an axis of one rank: no collective
                vals = fr.from_int(ph.parallel_fft_input(), CPU)
                ok["d1_fft"] = torch.equal(fft_sharded(fs, vals, flat),
                                           fft(fs, vals))
                _, pts = ph.parallel_g1_case(2)
                ok["d1_fft_g1"] = all(torch.equal(a, b) for a, b in zip(
                    fft_g1_sharded(fs, pts, flat, inverse=True),
                    fft_g1(fs, pts, inverse=True)))
                poly = fr.from_int(ph.FK20_COEFFS, CPU)
                res[2][0]["fk20_single"] = point_words(
                    da_using_fk20_multi_sharded(fks[2], poly, flat))
        ok["no_jax"] = not any(m == "jax" or m.startswith(("jax.", "kzg_tpu."))
                               or m == "kzg_tpu" for m in sys.modules)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        arrays = {f"D{D}/{k}": v for D, (out, _) in res.items()
                  for k, v in out.items()}
        outcomes = {D: {**ok, **o} for D, (_, o) in res.items()}
        np.savez(path, outcomes=np.asarray(json.dumps(outcomes)), **arrays)


if __name__ == "__main__":
    main()
