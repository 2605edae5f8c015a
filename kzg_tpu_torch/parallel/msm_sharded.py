"""The MSM sharded over the point axis (the counterpart of
kzg_tpu/parallel/msm_sharded.py): each rank sums its block of points
into the 64 window sums (`window_sums`: the multiples table on `g1_add`,
`fr_signed_windows`, one `g1_sum`), the D x 64 partials are gathered
(`all_gather`), one `g1_sum` adds them over D, and one `g1_horner`
folds the windows. The result is the same point on every rank.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..curve.kernels import g1_horner, g1_sum
from ..curve.msm import window_sums
from ..curve.weierstrass import JacobianPoint
from .mesh import all_gather, stacked, unstacked


def lin_comb_g1_sharded(points_block: JacobianPoint, scalars_block,
                        mesh: DeviceMesh, axis: str = "elem"):
    """sum_i k_i P_i over the points (N,) and Montgomery scalars (N, 8)
    held as this rank's blocks (N/D,) and (N/D, 8) of `axis`. Returns the
    point, coords (12,), on every rank. Blocks of unequal size raise
    ValueError, as a point count that does not divide D does in the
    reference."""
    group = mesh.get_group(axis)
    n = points_block.x.shape[0]
    sizes = all_gather(torch.tensor([n], device=points_block.x.device),
                       group)
    if bool((sizes != n).any()):
        raise ValueError("point count must divide the mesh axis")
    ws = window_sums(points_block, scalars_block)        # (64,) points
    parts = unstacked(all_gather(stacked(ws), group))      # (D, 64)
    return g1_horner(g1_sum(parts, dim=0))
