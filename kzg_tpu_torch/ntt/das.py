"""DAS FFT extension (reference: das_extension.go:7-84).

Given a degree-<n polynomial's values at the even points w^(2i) of the
2n-point domain, compute its values at the odd points w^(2i+1), so that
the interleaved 2n values have a zero top half of coefficients.

This is the reference's half-FFT recursion in the iterative form of
kzg_tpu/ntt/das.py::_das_core_pallas: K = log2 n DIF levels on
`fr_dif_stage`, K DIT levels on `fr_butterfly_stage`, and one `fr_scale`
by 1/n (the deferred 1/2 of every level). With stride_k = max_width /
(2n) * 2^k, the twiddles of level k are those of `_das_stage_tws`
(kzg_tpu/ntt/das.py:32-66): w^-(2 i stride_k) down and w^((1+2i) stride_k)
up, for i < n / 2^(k+1). Both are read from the domain's roots tables in
plain Montgomery form, the down ones at stride 2 stride_k, the up ones at
offset stride_k and stride 2 stride_k.
"""

from __future__ import annotations

import torch

from ..field import fr
from ..field.kernels import fr_butterfly_stage, fr_dif_stage, fr_scale
from .domain import FFTSettings


def _das_core(fs: FFTSettings, evens: torch.Tensor) -> torch.Tensor:
    n = evens.shape[-2]
    if n & (n - 1) or 2 * n > fs.max_width:
        raise ValueError("need a power-of-two count of values and a "
                         "domain at least twice as wide")
    K = n.bit_length() - 1
    stride0 = fs.max_width // (2 * n)
    # a fresh contiguous copy: the stages run in place
    x = evens.reshape(-1, n, fr.N_WORDS).clone(
        memory_format=torch.contiguous_format)
    for k in range(K):
        fr_dif_stage(fr.SPEC, x, fs.reverse_roots_of_unity, K - 1 - k,
                     2 * (stride0 << k))
    for k in range(K - 1, -1, -1):
        s = stride0 << k
        fr_butterfly_stage(fr.SPEC, x, fs.expanded_roots_of_unity,
                           K - 1 - k, 2 * s, offset=s)
    c = fr.from_int(pow(n, -1, fr.SPEC.modulus), x.device)
    return fr_scale(fr.SPEC, x, c).reshape(evens.shape)


def das_fft_extension(fs: FFTSettings, evens: torch.Tensor) -> torch.Tensor:
    """(..., n, 8) even-index evaluations -> (..., n, 8) odd-index ones."""
    return _das_core(fs, evens)


def das_extend_interleaved(fs: FFTSettings, evens: torch.Tensor):
    """The extended vector [e0, o0, e1, o1, ...], (..., 2n, 8)."""
    odds = _das_core(fs, evens)
    out = torch.stack((evens, odds), dim=-2)
    return out.reshape(evens.shape[:-2] + (2 * evens.shape[-2], fr.N_WORDS))
