"""FK20 multi (coset) proofs sharded over a mesh axis: the whole
DAUsingFK20Multi pipeline (reference: fk20_multi.go:113-133; the
counterpart of kzg_tpu/parallel/fk20_sharded.py).

The 2k proof/point axis is split in contiguous blocks over D ranks; the
l coset-offset axis stays on every rank (it is summed away). Each rank:

  1. builds the l strided Toeplitz vectors from the replicated n-value
     polynomial and keeps its block of the 2k axis;
  2. runs the sharded Fr FFT over the 2k axis, the l vectors batched;
  3. multiplies pointwise against the fixed-base tables of its block of
     the part-1 points only (`FK20MultiSettings.block_tables`: 1/D of
     the single-device tables) and sums over l (`g1_sum`);
  4. runs the sharded inverse G1 FFT, sets the top half (by global
     index) to infinity, and runs the sharded forward G1 FFT;
  5. runs the sharded reverse-bit-order shuffle.

The gathered blocks equal FK20MultiSettings.da_using_fk20_multi.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..curve import g1
from ..curve.kernels import g1_sum
from ..curve.weierstrass import JacobianPoint
from ..fk20.multi import FK20MultiSettings, toeplitz_coeffs_step_strided
from ..fk20.toeplitz import fixed_base_products
from .fft_g1_sharded import brp_shuffle_graph, g1_fft_graph
from .fft_sharded import (
    check_sharded_shape,
    fr_fft_graph,
    stage_twiddle_tables,
)
from .mesh import axis_size, stacked, unstacked


def da_using_fk20_multi_sharded(fks: FK20MultiSettings, poly,
                                mesh: DeviceMesh,
                                axis: str = "elem") -> JacobianPoint:
    """This rank's block (2k/D,) of the 2k coset proofs of the extended
    polynomial, in reverse-bit order. poly: (n, 8) Montgomery words,
    replicated. Requires 2k = D * local with local >= D."""
    n, l = fks.n, fks.chunk_len
    if poly.shape[0] != n:
        raise ValueError(f"expected polynomial of length {n}")
    two_k = 2 * fks.k
    D = axis_size(mesh, axis)
    fs = fks.ks.fs
    check_sharded_shape(two_k, D, fs.max_width)
    if D == 1:
        return fks.da_using_fk20_multi(poly)
    group = mesh.get_group(axis)
    s = mesh.get_local_rank(axis)
    local = two_k // D
    lo, hi = s * local, (s + 1) * local
    roots = fs.expanded_roots_of_unity
    # 1-2. the Toeplitz vectors' block, transformed over the 2k axis; the
    # poly's top half is zero by construction (fk20_multi.go:122-128), so
    # the vectors come from the n values
    tcs = torch.stack([toeplitz_coeffs_step_strided(poly, i, l)[lo:hi]
                       for i in range(l)])                   # (l, local, 8)
    c_fft = fr_fft_graph(tcs, stage_twiddle_tables(fs, roots, two_k, local),
                         roots, group=group, D=D, n=two_k,
                         max_width=fs.max_width, inverse=False)
    # 3. pointwise products on this block's tables, summed over l
    h = g1_sum(fixed_base_products(c_fft, fks.block_tables(lo, hi)), dim=0)
    # 4. inverse G1 FFT, the top half to infinity, forward G1 FFT
    h = g1_fft_graph(h, group=group, D=D, n=two_k, max_scale=fs.max_scale,
                     inverse=True)
    top = torch.arange(lo, hi, device=poly.device) >= fks.k
    h = g1.ops_kernel.select(top, g1.infinity((local,), poly.device),
                             h)
    proofs = g1_fft_graph(h, group=group, D=D, n=two_k,
                          max_scale=fs.max_scale, inverse=False)
    # 5. reverse-bit order across ranks
    return unstacked(brp_shuffle_graph(stacked(proofs), group=group, D=D,
                                    n=two_k))
