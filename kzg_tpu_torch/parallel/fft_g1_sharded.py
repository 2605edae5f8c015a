"""The G1 FFT sharded over a mesh axis, and the sharded reverse-bit-order
shuffle (the counterpart of kzg_tpu/parallel/fft_g1_sharded.py).

The plan of the Fr transform (fft_sharded.py) with point butterflies:
each cross stage is one `ppermute` block exchange, then the lower rank
of a pair keeps a + b (one `g1_add` launch) and the upper keeps
(a - b) w: one `g1_add` of a and -b, then K4 (`g1_glv_butterfly`) with
A = infinity on the GLV digits of its slice of the stage's twiddles.
Then the local transform (`_fft_g1_core` on the default plan, the
inverse scaled by the GLOBAL 1/n) and one `all_to_all` transpose. As
for the default `fft_g1`, the points must lie in the r-torsion subgroup.

`reverse_bit_order_g1_sharded` is reverseBitOrderG1
(reference: fft_g1.go:97-107) across ranks: one all_to_all and a static
local gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..curve import g1, glv
from ..curve.fft_g1 import _fft_g1_core, default_plan, fft_g1
from ..curve.kernels import g1_glv_butterfly
from ..curve.weierstrass import JacobianPoint, map_points
from ..field import fp, fr
from ..ntt.bitrev import bit_reversal_indices, brp_permute
from ..ntt.domain import FFTSettings, _expanded_roots_int
from .fft_sharded import (
    check_sharded_shape,
    cross_role,
    cross_stage_spans,
    transpose,
)
from .mesh import all_to_all, axis_size, ppermute, stacked, unstacked


@functools.lru_cache(maxsize=None)
def _cross_digits_host(max_scale: int, n: int, D: int, s: int,
                       inverse: bool) -> tuple:
    """Rank s's GLV digit rows (d1, d2), int32 (local, 33), for each cross
    stage where it is the upper rank of its pair (None where it keeps
    a + b): the twiddles w^((base + t) max_width/(2h)), t < local."""
    roots = _expanded_roots_int(max_scale)
    if inverse:
        roots = tuple(reversed(roots))
    local = n // D
    out = []
    for h in cross_stage_spans(n, local):
        base, _ = cross_role(s, h, local)
        if base is None:
            out.append(None)
            continue
        stride = (1 << max_scale) // (2 * h)
        out.append(glv.twiddle_digits(
            [roots[(base + t) * stride] for t in range(local)]))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def cross_digits(max_scale: int, n: int, D: int, s: int, inverse: bool,
                 device: torch.device) -> tuple:
    """_cross_digits_host on the device, copied once."""
    return tuple(None if d is None else
                 tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in d)
                 for d in _cross_digits_host(max_scale, n, D, s, inverse))


def g1_fft_graph(pts: JacobianPoint, *, group, D: int, n: int,
                 max_scale: int, inverse: bool) -> JacobianPoint:
    """The per-rank body: pts (..., local) points, this rank's contiguous
    block of the (..., n) transforms. Returns the same blocks of the
    natural-order transform."""
    local = n // D
    s = torch.distributed.get_rank(group)
    digits = cross_digits(max_scale, n, D, s, inverse, pts.x.device)
    x = pts
    for h, dig in zip(cross_stage_spans(n, local), digits):
        _, g = cross_role(s, h, local)
        px = unstacked(ppermute(stacked(x), group, g))
        if dig is None:
            x = g1.ops_kernel.add(x, px)
            continue
        diff = map_points(lambda c: c.reshape(-1, fp.N_WORDS),
                          g1.ops_kernel.sub(px, x))
        reps = diff.x.shape[0] // local
        d1, d2 = (d if reps == 1 else d.repeat(reps, 1) for d in dig)
        tw, _ = g1_glv_butterfly(g1.ops_kernel.infinity_like(diff), diff,
                                 d1, d2)
        x = map_points(lambda c: c.reshape(pts.x.shape), tw)
    inv_n = pow(n, -1, fr.SPEC.modulus) if inverse else None
    x = _fft_g1_core(x, max_scale, inverse, default_plan(local), inv_n)
    return unstacked(transpose(stacked(x), group, D))


def fft_g1_sharded(fs: FFTSettings, block: JacobianPoint, mesh: DeviceMesh,
                   axis: str = "elem", inverse: bool = False):
    """(I)FFT of a (..., n) G1 batch held as this rank's block (..., n/D)
    of `axis`, for points of the r-torsion subgroup. Requires n = D * local
    with local >= D, both powers of two. Equals the single-device fft_g1."""
    D = axis_size(mesh, axis)
    n = block.x.shape[-2] * D
    check_sharded_shape(n, D, fs.max_width)
    if D == 1:
        return fft_g1(fs, block, inverse=inverse)
    return g1_fft_graph(block, group=mesh.get_group(axis), D=D, n=n,
                        max_scale=fs.max_scale, inverse=inverse)


@functools.lru_cache(maxsize=None)
def _brp_local_indices(n: int, D: int) -> np.ndarray:
    """The static local gather after the all_to_all: rank b's received
    flat[s c + j] holds in[s local + j D + rev_D(b)], and the bit-reversed
    output needs out[t] = flat[rev_D(t % D) c + (rev_l(t) % c)]
    (rev_n(b local + t) = D rev_l(t) + rev_D(b))."""
    local = n // D
    c = local // D
    rev_d = bit_reversal_indices(D)
    rev_l = bit_reversal_indices(local)
    t = np.arange(local)
    return (rev_d[t % D] * c + (rev_l[t] % c)).astype(np.int64)


def brp_shuffle_graph(x: torch.Tensor, *, group, D: int,
                      n: int) -> torch.Tensor:
    """The per-rank reverse-bit-order permutation of a (n, ...) array held
    in contiguous blocks: x (local, ...), local >= D. One all_to_all."""
    if D == 1:
        return brp_permute(x, axis=0)
    local = n // D
    c = local // D
    rev_d = torch.as_tensor(bit_reversal_indices(D), device=x.device).long()
    # group u = j D + g by g = u mod D, and put group rev_D(b) in slice b,
    # which the all_to_all delivers to rank b
    xr = x.reshape((c, D) + tuple(x.shape[1:])).movedim(1, 0)[rev_d]
    flat = all_to_all(xr, group).reshape((local,) + tuple(x.shape[1:]))
    idx = torch.as_tensor(_brp_local_indices(n, D), device=x.device)
    return flat[idx]


def reverse_bit_order_g1_sharded(block: JacobianPoint, mesh: DeviceMesh,
                                 axis: str = "elem") -> JacobianPoint:
    """Sharded reverseBitOrderG1 of a (n,) batch held as this rank's block
    (n/D,): one all_to_all."""
    D = axis_size(mesh, axis)
    n = block.x.shape[0] * D
    out = brp_shuffle_graph(stacked(block), group=mesh.get_group(axis),
                            D=D, n=n)
    return unstacked(out)
