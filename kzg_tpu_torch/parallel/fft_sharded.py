"""The Fr FFT sharded over a mesh axis (the counterpart of
kzg_tpu/parallel/fft_sharded.py), on natural-order input in contiguous
blocks of the element axis over D ranks:

  1. log2(D) decimation-in-frequency stages whose span crosses ranks:
     each is one `ppermute` block exchange, then the lower rank of a
     pair keeps a + b (one `fr_add_sub` launch) and the upper keeps
     (a - b) w on its slice of the stage's twiddles (`fr_add_sub` and
     `mont_mul`);
  2. the local FFT of the block (`_fft_core` on `fr_fft_block`), the
     inverse scaled by the GLOBAL 1/n;
  3. one `all_to_all` transpose back to natural contiguous blocks.

The output equals the single-device transform word for word. Leading
batch axes are independent transforms and are not sharded.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..field import fr
from ..ntt.bitrev import bit_reversal_indices
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import _fft_core, take_strided
from .mesh import all_to_all, axis_size, ppermute


def cross_stage_spans(n: int, local: int) -> tuple:
    """Butterfly spans h = n/2 .. local that cross rank boundaries."""
    spans = []
    h = n // 2
    while h >= local:
        spans.append(h)
        h //= 2
    return tuple(spans)


def stage_twiddle_tables(fs: FFTSettings, roots, n: int, local: int):
    """The twiddles of each cross stage: stage h takes w^(r n/(2h)) for
    r < h, the root table strided by max_width/(2h)."""
    return tuple(take_strided(roots, h, fs.max_width // (2 * h))
                 for h in cross_stage_spans(n, local))


def check_sharded_shape(n: int, D: int, max_width: int) -> None:
    if n % D != 0:
        raise ValueError("n must be divisible by the mesh axis size")
    if n // D < D:
        # the transpose splits the local block into D pieces: each rank
        # holds at least one element for every other
        raise ValueError("need local >= D for the distributed transpose")
    if n & (n - 1) != 0:
        raise ValueError("n must be a power of two")
    if n > max_width:
        raise ValueError("n larger than the FFT domain")


def cross_role(s: int, h: int, local: int):
    """Rank s's part in the cross stage of span h: None for the lower
    rank of its pair (it keeps a + b), else the offset of its twiddles
    in the stage table (it keeps (a - b) w), and the partner's distance
    g (the partner is s ^ g)."""
    g = h // local
    s_mod = s % (2 * g)
    return (None if s_mod < g else (s_mod - g) * local), g


def transpose(x: torch.Tensor, group, D: int) -> torch.Tensor:
    """After the local transforms block s holds X[t D + rev_D(s)] at t:
    one all_to_all back to natural contiguous blocks. x: (..., local, W)."""
    *lead, local, w = x.shape
    c = local // D
    la = len(lead)
    xr = x.reshape(tuple(lead) + (D, c, w)).movedim(la, 0)   # (D, ..., c, w)
    recv = all_to_all(xr, group)                              # from rank j
    rev = torch.as_tensor(bit_reversal_indices(D), device=x.device).long()
    recv = recv[rev]                        # slot i: frequency residue i
    return recv.movedim(0, -2).reshape(x.shape)              # t D + i


def fr_fft_graph(block, stage_tables, roots, *, group, D: int, n: int,
                 max_width: int, inverse: bool):
    """The per-rank body: block (..., local, 8), this rank's contiguous
    block of the (..., n) transforms. Returns the same shape, natural
    order, the same blocks."""
    local = n // D
    s = torch.distributed.get_rank(group)
    x = block
    for h, table in zip(cross_stage_spans(n, local), stage_tables):
        base, g = cross_role(s, h, local)
        px = ppermute(x, group, g)
        if base is None:
            x = fr.add(x, px)
        else:
            x = fr.mul(fr.sub(px, x), table[base:base + local])
    # the local transform, scaled by 1/n of the whole (never 1/local)
    x = _fft_core(x, roots, n.bit_length() - 1 if inverse else None,
                  max_width)
    return transpose(x, group, D)


def fft_sharded(fs: FFTSettings, block, mesh: DeviceMesh,
                axis: str = "elem", inverse: bool = False):
    """(I)FFT of Montgomery Fr words (..., n, 8) held as this rank's
    block (..., n/D, 8) of `axis`. Requires n = D * local with local >= D,
    both powers of two. Returns this rank's block of the natural-order
    transform."""
    D = axis_size(mesh, axis)
    n = block.shape[-2] * D
    check_sharded_shape(n, D, fs.max_width)
    roots = (fs.reverse_roots_of_unity if inverse
             else fs.expanded_roots_of_unity)
    if D == 1:
        return _fft_core(block, roots, n.bit_length() - 1 if inverse
                         else None, fs.max_width)
    tables = stage_twiddle_tables(fs, roots, n, n // D)
    return fr_fft_graph(block, tables, roots, group=mesh.get_group(axis),
                        D=D, n=n, max_width=fs.max_width, inverse=inverse)
