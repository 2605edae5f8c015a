"""Legacy erasure recovery: an independent second implementation
(kzg_tpu/das/legacy.py; reference: ErasureCodeRecover,
legacy_recovery.go:162-283, with `_zPoly`, `multiInv` and `pOfKX`).

It shares no code with das/recovery.py and das/zero_poly.py, so the two
pipelines form a differential pair:
  * zero polynomial: direct monomial expansion over all missing roots at
    full width (O(m n) batched work, no FFT product tree);
  * pointwise division: its own Montgomery-trick batch inversion, with no
    zero mask (a zero poisons the batch, and the caller retries);
  * coset shift: a random factor k with a retry loop, per the legacy
    contract (legacy_recovery.go:203-281).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr, limbs
from ..field.constants import FR_MODULUS
from ..ntt.domain import FFTSettings
from ..ntt.fft_fr import _fft_core


def zero_poly_direct(fs: FFTSettings, missing_indices, length: int):
    """Z(x) = prod_{i in missing} (x - w^(i*stride)) by direct monomial
    expansion: one loop over the m factors, each step one shift-multiply-
    add over the full width. -> coefficients (length, 8), monic,
    zero-padded."""
    missing = sorted(int(i) for i in missing_indices)
    m = len(missing)
    if m >= length:
        raise ValueError("cannot build zero polynomial of full length")
    stride = fs.max_width // length
    dev = fs.device
    poly = fr.zeros((length,), dev)
    poly[0] = fr.from_int(1, dev)
    if m == 0:
        return poly
    idx = torch.tensor([i * stride for i in missing], device=dev)
    neg_roots = fr.neg(fs.expanded_roots_of_unity[idx])
    for negr in neg_roots:
        shifted = torch.cat((torch.zeros_like(poly[:1]), poly[:-1]))
        poly = fr.add(shifted, fr.mul(poly, negr))
    return poly


def batch_inv(vals):
    """Montgomery-trick batch inversion (reference: multiInv,
    legacy_recovery.go:49-65): inclusive prefix and suffix products by
    doubling, ONE Fermat inverse of the total, then
    inv_i = prefix_{i-1} * suffix_{i+1} * total^-1. All inputs must be
    nonzero: a zero poisons the whole batch."""
    n = vals.shape[0]
    if n == 1:
        return fr.inv(vals)
    prefix = limbs.prefix_products(fr.mul, vals)
    suffix = limbs.prefix_products(fr.mul, vals, reverse=True)
    total_inv = fr.inv(prefix[-1])
    one = fr.from_int([1], vals.device)
    ex_prefix = torch.cat((one, prefix[:-1]))
    ex_suffix = torch.cat((suffix[1:], one))
    return fr.mul(fr.mul(ex_prefix, ex_suffix), total_inv)


def p_of_kx(coeffs, k_mont):
    """p(x) -> p(k x): coefficient i times k^i (reference: pOfKX,
    legacy_recovery.go:68-78), the powers as an exclusive prefix product
    of k repeated."""
    n = coeffs.shape[0]
    pows = limbs.prefix_products(fr.mul, k_mont.expand(n, fr.N_WORDS))
    pows = torch.cat((fr.from_int([1], coeffs.device), pows[:-1]))
    return fr.mul(coeffs, pows)


def _legacy_recover_core(samples, missing_mask, z_coeffs, k_mont,
                         k_inv_mont, roots, rev_roots, max_width: int):
    """The legacy pipeline given Z's coefficients -> (recovered evals,
    shifted-Z evals); a zero in the latter calls for another k
    (legacy_recovery.go:243-254)."""
    inv_log2 = samples.shape[0].bit_length() - 1
    z_evals = _fft_core(z_coeffs, roots, None, max_width)
    e_vals = fr.select(missing_mask, torch.zeros_like(samples), samples)
    d_poly = _fft_core(fr.mul(e_vals, z_evals), rev_roots, inv_log2,
                       max_width)
    q1_evals = _fft_core(p_of_kx(d_poly, k_mont), roots, None, max_width)
    q2_evals = _fft_core(p_of_kx(z_coeffs, k_mont), roots, None, max_width)
    qs = fr.mul(q1_evals, batch_inv(q2_evals))
    d_over_z = _fft_core(qs, rev_roots, inv_log2, max_width)
    recovered = _fft_core(p_of_kx(d_over_z, k_inv_mont), roots, None,
                          max_width)
    return recovered, q2_evals


def erasure_code_recover(fs: FFTSettings, samples, missing_indices,
                         seed: int = 42, max_tries: int = 10):
    """Legacy recovery (reference: ErasureCodeRecover,
    legacy_recovery.go:162-283): a random coset shift k from
    np.random.default_rng(seed), retried until the shifted zero
    polynomial has no zero on the domain and the result keeps the known
    samples."""
    n = samples.shape[0]
    missing = list(missing_indices)
    if len(missing) > n // 2:
        raise ValueError("cannot recover from more than n/2 missing samples")
    z_coeffs = zero_poly_direct(fs, missing, n)
    mask = torch.zeros(n, dtype=torch.bool, device=samples.device)
    mask[torch.as_tensor(missing, dtype=torch.long,
                         device=samples.device)] = True
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        k = int(rng.integers(2, 1 << 30))
        if pow(k, n, FR_MODULUS) == 1:
            continue  # k inside the domain: shifted Z still vanishes
        recovered, q2 = _legacy_recover_core(
            samples, mask, z_coeffs, fr.from_int(k, samples.device),
            fr.from_int(pow(k, -1, FR_MODULUS), samples.device),
            fs.expanded_roots_of_unity, fs.reverse_roots_of_unity,
            fs.max_width)
        if bool(fr.is_zero(q2).any()):
            continue  # bad shift, retry with new k
        if bool((fr.eq(recovered, samples) | mask).all()):
            return recovered
    raise ValueError("erasure recovery failed after retries")
