"""The sharded paths (kzg_tpu_torch.parallel) on the CPU over gloo, at
D = 2 and D = 4 ranks, against the JAX package's kzg_tpu.parallel on
the same inputs (recorded by make_reference.py on its virtual CPU mesh)
and against the single-device paths. Exact: Fr as canonical words, G1 in
affine form.

The ranks are processes of their own (parallel_ranks.py, which imports no
JAX), four of them started once by a module fixture: D = 4 on all, D = 2
on the "elem" axis of a (2, 2) mesh; rank 0 writes the gathered outputs,
which the tests read.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    FK20_COEFFS,
    PAR_CORE_N,
    PAR_DS,
    PAR_G1_N,
    PAR_MSM_NS,
    PAR_SCALE,
    parallel_fft_input,
    parallel_g1_case,
    parallel_msm_scalars,
    ref_to_port,
    reference,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.curve import fft_g1 as F
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.parallel.fft_g1_sharded import _brp_local_indices
from kzg_tpu_torch.parallel.fft_sharded import (
    check_sharded_shape,
    cross_stage_spans,
)
from kzg_tpu_torch.parallel.mesh import mesh_shape

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS_TIMEOUT_S = 300
WORLD = max(PAR_DS)     # one world of ranks serves every D


def run_ranks(out: str) -> None:
    """Start the WORLD ranks of parallel_ranks.py; rank 0 writes `out`."""
    store = out + ".store"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "parallel_ranks.py"), str(r),
         str(WORLD), store, out + ".tmp.npz"], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        errs = [p.communicate(timeout=RANKS_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {WORLD} exited {p.returncode}:"
                               f"\n{err[-4000:]}")
    os.replace(out + ".tmp.npz", out)


@pytest.fixture(scope="module")
def rank_outputs(tmp_path_factory):
    """Run the ranks once a test session; -> (rank 0's arrays, outcomes by
    D). Under pytest-xdist the workers share one run: the first to take
    the lock file runs the ranks, the others wait for its output (or its
    failure)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent              # the session's, shared by workers
    out = str(base / "parallel_ranks.npz")
    try:
        os.close(os.open(out + ".lock", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.time() + RANKS_TIMEOUT_S + 60
        while not os.path.exists(out):
            if os.path.exists(out + ".failed"):
                with open(out + ".failed") as f:
                    raise RuntimeError(f.read())
            assert time.time() < deadline, "no output from the ranks"
            time.sleep(0.5)
    else:
        try:
            run_ranks(out)
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            with open(out + ".failed", "w") as f:
                f.write(str(e))
            raise
    with np.load(out) as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("outcomes")))


@pytest.fixture(params=PAR_DS, ids=lambda d: f"D{d}")
def ranks(request, rank_outputs):
    """-> (D, the D ranks' gathered arrays, their outcomes)."""
    D = request.param
    arrays, outcomes = rank_outputs
    prefix = f"D{D}/"
    return (D, {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}, outcomes[str(D)])


def points(words) -> JacobianPoint:
    return JacobianPoint(*(torch.from_numpy(c) for c in words))


def affine(words) -> list:
    """Affine ints with the inverses on the host (no plain ladder)."""
    return g1.to_affine_ints_host(points(words))


def recorded_affine(key: str, *inputs) -> list:
    return g1.to_affine_ints_host(ref_to_port(reference(key, *inputs)))


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_sharded_matches_reference(ranks, inverse):
    D, got, _ = ranks
    vals = parallel_fft_input()
    want = reference(f"par_fft:{D}:{int(inverse)}", jfr.from_int(vals))
    assert torch.equal(torch.from_numpy(got[f"fft:{int(inverse)}"]),
                       convert.words_from_ref(want, CPU))


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_g1_sharded_matches_reference(ranks, inverse):
    D, got, _ = ranks
    _, pts = parallel_g1_case(PAR_G1_N)
    want = recorded_affine(f"par_fft_g1:{D}:{int(inverse)}",
                           *convert.point_to_ref(pts))
    assert affine(got[f"fft_g1:{int(inverse)}"]) == want


def test_reverse_bit_order_g1_sharded_matches_reference(ranks):
    D, got, _ = ranks
    _, pts = parallel_g1_case(PAR_G1_N)
    want = reference(f"par_brp_g1:{D}", *convert.point_to_ref(pts))
    assert all(torch.equal(torch.from_numpy(a), b)
               for a, b in zip(got["brp_g1"], ref_to_port(want)))


@pytest.mark.parametrize("n", PAR_MSM_NS)
def test_lin_comb_g1_sharded_matches_reference(ranks, n):
    D, got, ok = ranks
    _, pts = parallel_g1_case(n)
    sc = jfr.from_int(parallel_msm_scalars(n))
    want = recorded_affine(f"par_msm:{D}:{n}", *convert.point_to_ref(pts),
                           sc)
    assert affine(got[f"msm:{n}"][:, None]) == want
    assert ok[f"msm_replicated:{n}"]


def test_fk20_sharded_matches_single_device(ranks):
    """n = 8, n2 = 16, l = 2: 8 proofs, 4 a rank at D = 2 (at D = 4 a rank
    would hold 2 < D and the call raises)."""
    D, got, ok = ranks
    if D != 2:
        assert ok["fk20_small_local_raises"]
        return
    want = recorded_affine("fk20:2:da", jfr.from_int(FK20_COEFFS), 2)
    assert affine(got["fk20"]) == want
    # the D == 1 path is the port's single-device FK20
    assert affine(got["fk20_single"]) == want


@pytest.mark.parametrize("check", [
    "rows_round_trip", "points_round_trip", "fft_batch",
    "fk20_wrong_length_raises", "fft_small_local_raises",
    "fft_not_pow2_raises", "fft_too_wide_raises", "g1_small_local_raises",
    "shard_rows_raises", "msm_unequal_raises", "default_mesh", "data_axis",
    "elem_of_one", "d1_fft", "d1_fft_g1", "no_jax"])
def test_rank_checks(ranks, check):
    """Round trips of shard_rows/gather_rows, batch axes, the reference's
    ValueErrors, mesh shapes and the D == 1 path, checked in the ranks;
    no rank loads JAX or kzg_tpu."""
    _, _, ok = ranks
    assert ok[check] is True


def test_mesh_shape_rule():
    """The reference's default shape (kzg_tpu/parallel/mesh.py:30-37)."""
    assert mesh_shape(8, ("data", "elem")) == (1, 8)
    assert mesh_shape(6, ("data", "elem")) == (3, 2)
    assert mesh_shape(12, ("data", "elem")) == (3, 4)
    assert mesh_shape(1, ("data", "elem")) == (1, 1)
    assert mesh_shape(4, ("elem",)) == (4,)


def test_sharded_shape_checks():
    check_sharded_shape(32, 4, 64)
    for n, D, width in ((30, 4, 64), (8, 4, 64), (48, 4, 64),
                        (128, 4, 64)):
        with pytest.raises(ValueError):
            check_sharded_shape(n, D, width)
    assert cross_stage_spans(32, 8) == (16, 8)
    assert cross_stage_spans(32, 32) == ()


@pytest.mark.parametrize("n,D", [(16, 2), (16, 4), (64, 4), (64, 8)])
def test_brp_local_indices_permute_blocks(n, D):
    """The shuffle's gather, simulated: rank b's received buffer holds
    in[s local + j D + rev_D(b)] at s c + j, and the gather must give
    rank b's block of the bit-reversed array."""
    from kzg_tpu_torch.ntt.bitrev import bit_reversal_indices

    local, c = n // D, n // D // D
    rev_n, rev_d = bit_reversal_indices(n), bit_reversal_indices(D)
    for b in range(D):
        flat = np.array([s * local + j * D + rev_d[b]
                         for s in range(D) for j in range(c)])
        got = flat[_brp_local_indices(n, D)]
        assert got.tolist() == rev_n[b * local:(b + 1) * local].tolist()


def test_fft_g1_core_global_inverse_scale():
    """The local inverse with an explicit scale (a sharded transform's
    1/n of the whole) against the reference's _fft_g1_core with inv_n on
    the same block. With the default scale, 1/n of the transform's own
    length, fft_g1 is held to its recorded cases by
    test_torch_curve.py::test_fft_g1_matches_reference."""
    _, pts = parallel_g1_case(PAR_CORE_N)
    inv = pow(2 * PAR_CORE_N, -1, fr.SPEC.modulus)
    got = F._fft_g1_core(pts, PAR_SCALE, True, F.default_plan(PAR_CORE_N),
                         inv)
    assert g1.to_affine_ints_host(got) == recorded_affine(
        "par_g1_core_inv", *convert.point_to_ref(pts))
