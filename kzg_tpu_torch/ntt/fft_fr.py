"""Radix-2 (I)FFT over Fr: bit-reversal, then log2(n) DIT stages on
kernel K2, and for the inverse one scale by 2^-k on `fr_scale` (K1).

Forward computes out[i] = sum_j vals[j] w^(i j) with the expanded roots;
the inverse uses the reverse roots and scales by 1/n
(reference: fft_fr.go:76-105; kzg_tpu/ntt/fft_fr.py:91-116).
"""

from __future__ import annotations

import torch

from ..field import fr
from ..field.kernels import fr_butterfly_stage, fr_scale
from .bitrev import brp_permute
from .domain import FFTSettings, next_pow_of_2


def _fft_core(vals: torch.Tensor, roots: torch.Tensor, inv_log2,
              max_width: int) -> torch.Tensor:
    """vals (..., n, 8), n a power of two. inv_log2: None (forward) or the
    log2 of the inverse scale's denominator, given by the caller and never
    derived from the shape (a sharded local IFFT scales by the global n).
    0 is an inverse transform scaled by 2^0 = 1, distinct from None."""
    n = vals.shape[-2]
    batch_shape = vals.shape[:-2]
    # a fresh contiguous copy: the stages run in place
    x = brp_permute(vals, axis=-2).reshape(-1, n, fr.N_WORDS).clone(
        memory_format=torch.contiguous_format)
    logn = n.bit_length() - 1
    for s in range(1, logn + 1):
        fr_butterfly_stage(fr.SPEC, x, roots, s - 1, max_width >> s)
    if inv_log2 is not None:
        c = fr.from_int(pow(1 << inv_log2, -1, fr.SPEC.modulus), x.device)
        x = fr_scale(fr.SPEC, x, c)
    return x.reshape(batch_shape + (n, fr.N_WORDS))


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
