"""Radix-2 (I)FFT over Fr on `fr_fft_block`: the log2(n) DIT stages in
passes of up to 11 stages each in shared memory, the first pass reading
the input in bit-reversed order, the last scaling an inverse by 2^-k in
its store (K2's route).

Forward computes out[i] = sum_j vals[j] w^(i j) with the expanded roots;
the inverse uses the reverse roots and scales by 1/n
(reference: fft_fr.go:76-105; kzg_tpu/ntt/fft_fr.py:91-116).
"""

from __future__ import annotations

import torch

from ..field import fr
from ..field.kernels import fr_fft_block
from .domain import FFTSettings, next_pow_of_2


def _fft_core(vals: torch.Tensor, roots: torch.Tensor, inv_log2,
              max_width: int) -> torch.Tensor:
    """vals (..., n, 8), n a power of two. inv_log2: None (forward) or the
    log2 of the inverse scale's denominator, given by the caller and never
    derived from the shape (a sharded local IFFT scales by the global n).
    0 is an inverse transform scaled by 2^0 = 1, distinct from None."""
    n = vals.shape[-2]
    scale = None if inv_log2 is None else pow(1 << inv_log2, -1,
                                              fr.SPEC.modulus)
    x = fr_fft_block(fr.SPEC, vals.reshape(-1, n, fr.N_WORDS), roots,
                     max_width, scale)
    return x.reshape(vals.shape)


def fft(fs: FFTSettings, vals: torch.Tensor, inverse: bool = False):
    """(I)FFT of int32 (..., n, 8) Montgomery Fr values, zero-padded to
    the next power of two (reference: fft_fr.go:55-74)."""
    n = vals.shape[-2]
    if n > fs.max_width:
        raise ValueError(
            f"got {n} values but only have {fs.max_width} roots of unity")
    n2 = next_pow_of_2(n)
    if n2 != n:
        vals = torch.nn.functional.pad(vals, (0, 0, 0, n2 - n))
    if inverse:
        return _fft_core(vals, fs.reverse_roots_of_unity,
                         n2.bit_length() - 1, fs.max_width)
    return _fft_core(vals, fs.expanded_roots_of_unity, None, fs.max_width)


def take_strided(roots: torch.Tensor, count: int, stride: int):
    """roots[0 : count * stride : stride], (count, 8)."""
    return roots[:count * stride:stride]


def coset_scale(fs: FFTSettings, n: int, inverse: bool = False):
    """[g^0, ..., g^(n-1)] for g the domain's 2n-th root of unity (its
    inverse with `inverse`), the DAS extension's coset offset: (n, 8)."""
    roots = (fs.reverse_roots_of_unity if inverse
             else fs.expanded_roots_of_unity)
    return take_strided(roots, n, fs.max_width // (2 * n))
