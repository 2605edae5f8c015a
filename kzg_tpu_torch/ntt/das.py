"""DAS FFT extension (reference: das_extension.go:7-84).

Given a degree-<n polynomial's values at the even points w^(2i) of the
2n-point domain, compute its values at the odd points w^(2i+1), so that
the interleaved 2n values have a zero top half of coefficients.

This is the reference's half-FFT recursion in the iterative form of
kzg_tpu/ntt/das.py::_das_core_pallas: K = log2 n DIF levels, K DIT
levels and one scale by 1/n (the deferred 1/2 of every level), with the
twiddles of `_das_stage_tws` (kzg_tpu/ntt/das.py:32-66), read from the
domain's roots tables. All of it runs in `fr_das_block`'s passes in
shared memory: one launch up to 2^11 values, three above (the PeerDAS
blob's 4096), for any batch of vectors.
"""

from __future__ import annotations

import torch

from ..field import fr
from ..field.kernels import fr_das_block
from .domain import FFTSettings


def das_fft_extension(fs: FFTSettings, evens: torch.Tensor) -> torch.Tensor:
    """(..., n, 8) even-index evaluations -> (..., n, 8) odd-index ones."""
    return fr_das_block(fr.SPEC, evens, fs.reverse_roots_of_unity,
                        fs.expanded_roots_of_unity, fs.max_width)


def das_extend_interleaved(fs: FFTSettings, evens: torch.Tensor):
    """The extended vector [e0, o0, e1, o1, ...], (..., 2n, 8)."""
    return fr_das_block(fr.SPEC, evens, fs.reverse_roots_of_unity,
                        fs.expanded_roots_of_unity, fs.max_width, True)
