"""Point-batch reductions. Only `tree_reduce` is ported so far; the
windowed MSM (kzg_tpu/curve/msm.py) comes with the commit slice."""

from __future__ import annotations

import torch

from .weierstrass import JacobianPoint, map_points


def tree_reduce(ops, points: JacobianPoint) -> JacobianPoint:
    """Sum a (N, ...) point batch along axis 0 by halving: one batched
    complete add per level (an odd level is padded with infinity)."""
    n = points.x.shape[0]
    while n > 1:
        if n % 2 == 1:
            pad = ops.infinity_like(map_points(lambda c: c[:1], points))
            points = map_points(lambda c, p: torch.cat((c, p)), points, pad)
            n += 1
        points = ops.add(map_points(lambda c: c[0::2], points),
                         map_points(lambda c: c[1::2], points))
        n //= 2
    return map_points(lambda c: c[0], points)
