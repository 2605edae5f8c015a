"""Erasure-coded data recovery from partial evaluations
(kzg_tpu/das/recovery.py; reference: RecoverPolyFromSamples, ShiftPoly,
UnshiftPoly, recover_from_samples.go:9-109).

Given at least half of the evaluations of a polynomial of degree < n/2 on
a power-of-two domain (the DAS extended data), rebuild all of them:

    (p*Z)  =  IFFT(samples_masked * Z_evals)          Z = zero poly of the
    p      =  unshift( FFT(shift(p*Z)) / FFT(shift(Z)) )   missing set

The coset shift by k = 5 moves the evaluation points off the domain so
that the division is defined; the division is one Montgomery-trick batch
inversion. Which samples are missing is host data.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import poly
from ..field import fr
from ..field.constants import FR_MODULUS
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import _fft_core
from .zero_poly import leaf_layout, zero_poly_graph

SHIFT_FACTOR = 5  # reference: recover_from_samples.go:9 (shiftFactor)


def _recover_core(samples, missing_mask, zero_eval, zero_coeffs,
                  shift_mont, shift_inv_mont, roots, rev_roots,
                  max_width: int):
    """The shift-divide-unshift pipeline -> (recovered, shifted Z evals)."""
    n = samples.shape[0]
    inv_log2 = n.bit_length() - 1
    masked = fr.select(missing_mask, torch.zeros_like(samples), samples)
    pz = _fft_core(fr.mul(masked, zero_eval), rev_roots, inv_log2, max_width)
    scale = poly.powers_of(shift_mont, n)
    scale_inv = poly.powers_of(shift_inv_mont, n)
    eval_pz = _fft_core(fr.mul(pz, scale), roots, None, max_width)
    eval_z = _fft_core(fr.mul(zero_coeffs, scale), roots, None, max_width)
    # eval_z has no zero: that needs shift*w^i to be a root of Z, i.e. the
    # shift inside the domain, which recover_poly_from_samples rejects
    eval_p = fr.mul(eval_pz, fr.batch_inv(eval_z))
    shifted_p = _fft_core(eval_p, rev_roots, inv_log2, max_width)
    recovered = _fft_core(fr.mul(shifted_p, scale_inv), roots, None,
                          max_width)
    return recovered, eval_z


def shift_poly(coeffs, factor: int = SHIFT_FACTOR):
    """p(x) -> p(k x): coefficient i times k^i (reference: ShiftPoly,
    recover_from_samples.go:9-21)."""
    n = coeffs.shape[-2]
    scale = poly.powers_of(fr.from_int(factor, coeffs.device), n)
    return fr.mul(coeffs, scale)


def unshift_poly(coeffs, factor: int = SHIFT_FACTOR):
    """p(x) -> p(x / k) (reference: UnshiftPoly,
    recover_from_samples.go:24-40)."""
    return shift_poly(coeffs, pow(factor, -1, FR_MODULUS))


def recover_poly_from_samples(fs: FFTSettings, samples, missing_indices):
    """Rebuild the full evaluation vector (n, 8) from `samples` (n, 8),
    whose lanes at the host ints `missing_indices` may hold anything
    (reference: RecoverPolyFromSamples, recover_from_samples.go:42-109).

    Needs deg(p) + len(missing) < n: a DAS-extended polynomial has
    deg < n/2 and tolerates n/2 missing. Raises ValueError for more than
    n/2 missing, a shift factor inside the domain, a width that is not a
    power of two or is wider than the domain, and, as the reference's
    self-check (recover_from_samples.go:103-107), when the result
    disagrees with a known sample."""
    n = samples.shape[0]
    missing = np.asarray(sorted(int(i) for i in missing_indices),
                         dtype=np.int64)
    if missing.shape[0] > n // 2:
        raise ValueError("cannot recover from more than n/2 missing samples")
    if pow(SHIFT_FACTOR, n, FR_MODULUS) == 1:
        raise ValueError("shift factor lies in the evaluation domain")
    if missing.shape[0] == 0:
        return samples
    if n & (n - 1) != 0:
        raise ValueError("width must be a power of two")
    if n > fs.max_width:
        raise ValueError("width larger than domain")
    idx, valid, _ = leaf_layout(fs, missing, n, fs.max_width // n)
    zero_eval, zero_coeffs = zero_poly_graph(
        idx, valid, fs.expanded_roots_of_unity, fs.reverse_roots_of_unity,
        n, fs.max_width)
    mask = torch.zeros(n, dtype=torch.bool, device=samples.device)
    mask[torch.as_tensor(missing, device=samples.device)] = True
    recovered, _ = _recover_core(
        samples, mask, zero_eval, zero_coeffs,
        fr.from_int(SHIFT_FACTOR, samples.device),
        fr.from_int(pow(SHIFT_FACTOR, -1, FR_MODULUS), samples.device),
        fs.expanded_roots_of_unity, fs.reverse_roots_of_unity, fs.max_width)
    if not bool((fr.eq(recovered, samples) | mask).all()):
        raise ValueError("recovery self-check failed: inconsistent samples")
    return recovered
