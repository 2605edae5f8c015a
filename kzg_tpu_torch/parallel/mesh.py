"""Device meshes and the collectives of the sharded paths (the
counterpart of kzg_tpu/parallel/mesh.py).

JAX runs one controller over a `Mesh`; here every rank is a process of
its own (`torch.distributed`), and a sharded function takes and returns
this rank's contiguous block of the point/element axis (dim -2): rank s
of the "elem" axis holds rows s*local:(s+1)*local. `shard_rows` and
`gather_rows` convert between a replicated tensor and the blocks.

The collectives run on `mesh.get_group(axis)`. On an NCCL group the
tensors stay on the card. A gloo group carries CPU tensors (several ranks
on one card, where NCCL refuses two ranks a device): `_transport` stages
a CUDA tensor through host memory around the collective, here and
nowhere else. Compute stays on the tensors' device either way.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..curve.weierstrass import JacobianPoint, map_points


class CollectiveClock:
    """Calls of each collective, and, while `timed` is set, the wall
    seconds spent in them, the device synchronised on both sides."""

    def __init__(self):
        self.calls = collections.Counter()
        self.seconds = 0.0
        self.timed = False

    def reset(self) -> None:
        self.calls.clear()
        self.seconds = 0.0


CLOCK = CollectiveClock()


def mesh_shape(n_devices: int, axes) -> tuple:
    """The reference's default shape: one axis takes every device; with
    two, "elem" (the communication-heavy axis) takes the largest power of
    two dividing n_devices and "data" the rest."""
    if len(axes) == 1:
        return (n_devices,)
    elem = 1
    while elem * 2 <= n_devices and n_devices % (elem * 2) == 0:
        elem *= 2
    return (n_devices // elem, elem)


def make_mesh(n_devices: int | None = None, axes=("data", "elem"),
              shape=None, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over ranks 0..n_devices-1 of the initialised process group
    (all of them by default), named `axes`. Every rank of the group
    calls it: it makes each axis's process groups."""
    if n_devices is None:
        n_devices = dist.get_world_size()
    if shape is None:
        shape = mesh_shape(n_devices, axes)
    ranks = torch.arange(n_devices).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _transport(group, x: torch.Tensor, run) -> torch.Tensor:
    """run(contiguous input) -> output, on the group's transport: a CUDA
    tensor on a gloo group goes through host memory both ways."""
    t0 = None
    if CLOCK.timed:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        out = run(x.contiguous().cpu()).to(x.device)
    else:
        out = run(x.contiguous())
    if t0 is not None:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        CLOCK.seconds += time.perf_counter() - t0
    return out


def ppermute(x: torch.Tensor, group, g: int) -> torch.Tensor:
    """The pairwise exchange: rank i of the group receives rank i ^ g's
    x (lax.ppermute with the pairs (i, i ^ g))."""
    CLOCK.calls["ppermute"] += 1
    peer = dist.get_global_rank(group, dist.get_rank(group) ^ g)

    def run(t):
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, peer, group),
            dist.P2POp(dist.irecv, out, peer, group)])
        for r in reqs:
            r.wait()
        return out

    return _transport(group, x, run)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Slice j of x's dim 0 goes to rank j; slice j of the result came
    from rank j (lax.all_to_all with split and concat on one axis)."""
    CLOCK.calls["all_to_all"] += 1

    def run(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    return _transport(group, x, run)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x stacked on a new dim 0, in rank order."""
    CLOCK.calls["all_gather"] += 1
    D = dist.get_world_size(group)

    def run(t):
        out = t.new_empty((D,) + tuple(t.shape))
        dist.all_gather(list(out.unbind(0)), t, group=group)
        return out

    return _transport(group, x, run)


def stacked(p: JacobianPoint) -> torch.Tensor:
    """A point batch as one tensor, its coordinates side by side on the
    last axis, so that a collective moves it in one call."""
    return torch.cat(tuple(p), dim=-1)


def unstacked(t: torch.Tensor) -> JacobianPoint:
    return JacobianPoint(*(c.contiguous() for c in t.chunk(3, dim=-1)))


def shard_rows(x, mesh: DeviceMesh, axis: str = "elem"):
    """This rank's contiguous block along dim -2 of a replicated tensor
    or point batch."""
    if isinstance(x, JacobianPoint):
        return map_points(lambda c: shard_rows(c, mesh, axis), x)
    D = axis_size(mesh, axis)
    if x.shape[-2] % D != 0:
        raise ValueError("n must be divisible by the mesh axis size")
    local = x.shape[-2] // D
    s = mesh.get_local_rank(axis)
    return x[..., s * local:(s + 1) * local, :].contiguous()


def gather_rows(block, mesh: DeviceMesh, axis: str = "elem"):
    """The whole array from every rank's block along dim -2 (blocks of
    one size); every rank gets it."""
    if isinstance(block, JacobianPoint):
        return unstacked(gather_rows(stacked(block), mesh, axis))
    got = all_gather(block, mesh.get_group(axis))       # (D, ..., local, W)
    return torch.cat(got.unbind(0), dim=-2)
