"""Zero polynomial Z(x) = prod_{i in missing} (x - w^(i*stride))
(kzg_tpu/das/zero_poly.py; reference: ZeroPolyViaMultiplication,
zero_poly.go:116-217).

  1. leaves of up to 64 linear factors, all built in one launch of
     `fr_zero_poly_leaves` (one block a leaf, one step a factor);
  2. a binary product tree whose every level is one batched FFT
     convolution over all remaining pairs.
The missing-index set is host data; the leaf count is padded to a power
of two with identity leaves, as in the JAX package, so that the tree and
the zero tail of the coefficients are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr
from ..field.kernels import LEAF_FACTORS, fr_zero_poly_leaves
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import _fft_core, fft


def _reduce_level(polys, roots, rev_roots, max_width: int, target: int):
    """One tree level: multiply adjacent pairs by FFT convolution at width
    `target`. polys (cnt, width, 8) -> (cnt/2, target, 8)."""
    pad = (0, 0, 0, target - polys.shape[1])
    fa = _fft_core(torch.nn.functional.pad(polys[0::2], pad), roots, None,
                   max_width)
    fb = _fft_core(torch.nn.functional.pad(polys[1::2], pad), roots, None,
                   max_width)
    return _fft_core(fr.mul(fa, fb), rev_roots, target.bit_length() - 1,
                     max_width)


def zero_poly_graph(root_idx, valid, roots, rev_roots, length: int,
                    max_width: int):
    """Leaf build, product tree and the final forward FFT. root_idx and
    valid are host (G, S) arrays from `leaf_layout`. -> (evals, coeffs),
    each (length, 8)."""
    polys = fr_zero_poly_leaves(fr.SPEC, roots, root_idx, valid)
    while polys.shape[0] > 1:
        target = min(2 * polys.shape[1], length)
        polys = _reduce_level(polys, roots, rev_roots, max_width, target)
    zpoly = polys[0]
    if zpoly.shape[0] < length:
        zpoly = torch.nn.functional.pad(zpoly,
                                        (0, 0, 0, length - zpoly.shape[0]))
    else:
        # degree m < length: truncation only drops structural zeros
        zpoly = zpoly[:length]
    return _fft_core(zpoly, roots, None, max_width), zpoly


def leaf_layout(fs: FFTSettings, missing: np.ndarray, length: int,
                stride: int):
    """Host-side leaf packing: the missing roots' indices in leaves of
    LEAF_FACTORS, the leaf count padded to a power of two (identity
    leaves through the validity mask).
    Returns (idx (G, S) int32, valid (G, S) bool, G)."""
    m = missing.shape[0]
    G = 1 << (max((m + LEAF_FACTORS - 1) // LEAF_FACTORS, 1) - 1).bit_length()
    S = LEAF_FACTORS
    idx = np.zeros((G, S), dtype=np.int32)
    valid_np = np.zeros((G, S), dtype=bool)
    flat_leaf = np.arange(m) // S
    flat_pos = np.arange(m) % S
    idx[flat_leaf, flat_pos] = (missing * stride).astype(np.int32)
    valid_np[flat_leaf, flat_pos] = True
    return idx, valid_np, G


def zero_poly_via_multiplication(fs: FFTSettings, missing_indices,
                                 length: int):
    """-> (zero_eval (length, 8), zero_coeffs (length, 8)): the monic Z
    padded with zeros to `length` and its FFT on the length-domain
    (reference contract, zero_poly.go:116-130). missing_indices: host
    ints in [0, length); length a power of two <= fs.max_width."""
    missing = np.asarray(sorted(int(i) for i in missing_indices),
                         dtype=np.int64)
    m = missing.shape[0]
    if length & (length - 1) != 0:
        raise ValueError("length must be a power of two")
    if length > fs.max_width:
        raise ValueError("length larger than domain")
    if m >= length:
        raise ValueError("cannot build zero polynomial of full length")
    stride = fs.max_width // length
    if m == 0:
        coeffs = fr.zeros((length,), fs.device)
        coeffs[0] = fr.from_int(1, fs.device)
        return fft(fs, coeffs), coeffs
    idx, valid, _ = leaf_layout(fs, missing, length, stride)
    return zero_poly_graph(idx, valid, fs.expanded_roots_of_unity,
                           fs.reverse_roots_of_unity, length, fs.max_width)
