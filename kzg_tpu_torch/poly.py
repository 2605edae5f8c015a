"""Polynomial primitives over Fr: evaluation, linear combination, division
(kzg_tpu/poly.py; reference: bls/globals.go:76-178, poly.go:6-40).

Polynomials are int32 (n, 8) Montgomery Fr tensors, coefficient 0 first.
Where the reference loops element by element, these run the whole
polynomial at once; the genuinely serial recurrences (Horner, synthetic
and long division), `lax.scan`s in the JAX package, are Python loops over
tensors here.
"""

from __future__ import annotations

import torch

from .field import fr
from .ntt.fft_fr import fft


def sum_fr(vals, axis: int = -2):
    """Field sum along a batch `axis` (negative axes count from the last
    batch axis, before the word axis) by a pairwise tree, padding an odd
    level with zero."""
    vals = torch.movedim(vals, axis if axis >= 0 else axis + vals.dim() - 1,
                         0)
    n = vals.shape[0]
    while n > 1:
        if n % 2 == 1:
            vals = torch.cat((vals, torch.zeros_like(vals[:1])))
            n += 1
        vals = fr.add(vals[0::2], vals[1::2])
        n //= 2
    return vals[0]


def powers_of(x, n: int):
    """[x^0, ..., x^(n-1)] as (..., n, 8) for x (..., 8), by doubling:
    each step multiplies the powers so far by x^m, then squares x^m."""
    out = fr.from_int([1], x.device).expand(x.shape[:-1] + (1, fr.N_WORDS))
    cur = x if x.dim() == 1 else x.unsqueeze(-2)
    while out.shape[-2] < n:
        out = torch.cat((out, fr.mul(out, cur)), dim=-2)
        cur = fr.mul(cur, cur)
    return out[..., :n, :]


def eval_poly_at(coeffs, x):
    """Horner evaluation at a batch of points x (..., 8) (reference:
    EvalPolyAtUnoptimized, bls/globals.go:76-95)."""
    n = coeffs.shape[0]
    if n == 0:
        return torch.zeros_like(x)
    acc = coeffs[n - 1].expand(x.shape)
    for i in range(n - 2, -1, -1):
        acc = fr.add(fr.mul(acc, x), coeffs[i].expand(x.shape))
    return acc


def eval_poly_at_parallel(coeffs, x):
    """p(x) for one point x (8,) through the powers of x and a tree sum:
    log depth instead of Horner's n steps, the same value."""
    pw = powers_of(x, coeffs.shape[0])
    return sum_fr(fr.mul(coeffs, pw), axis=0)


def eval_poly_in_evaluation_form(evals, domain, x, width_inv):
    """Barycentric evaluation p(x) = (x^n - 1)/n * sum_i e_i w_i/(x - w_i)
    (reference: EvaluatePolyInEvaluationForm, bls/globals.go:106-153).
    evals and domain (n, 8) in matching order, x (8,), width_inv 1/n. A
    point on the domain returns its stored evaluation: those lanes'
    denominators are replaced by 1 before the batch inversion."""
    n = evals.shape[0]
    diff = fr.sub(x.expand(domain.shape), domain)
    on_domain = fr.is_zero(diff)
    one = fr.from_int(1, x.device)
    inv_diff = fr.batch_inv(fr.select(on_domain, one, diff))
    s = sum_fr(fr.mul(fr.mul(evals, domain), inv_diff), axis=0)
    factor = fr.mul(fr.sub(fr.pow_static(x, n), one), width_inv)
    result = fr.mul(s, factor)
    exact = sum_fr(fr.select(on_domain, evals, torch.zeros_like(evals)),
                   axis=0)
    return fr.select(on_domain.any(), exact, result)


def poly_lin_comb(polys, scalars):
    """sum_i scalars[i] * polys[i]: (k, n, 8) x (k, 8) -> (n, 8)
    (reference: PolyLinComb, bls/globals.go:155-178)."""
    return sum_fr(fr.mul(polys, scalars[:, None, :]), axis=0)


def poly_factor_div(coeffs, z):
    """Synthetic division by (x - z): the quotient (n-1, 8), remainder
    dropped (reference: polyLongDiv with divisor [-z, 1], poly.go:14-40).
    b_{n-1} = a_{n-1}, b_i = a_i + z b_{i+1}; the quotient is b_1..b_{n-1}."""
    n = coeffs.shape[0]
    if n < 2:
        return coeffs[:0]
    q = [coeffs[n - 1]]
    for i in range(n - 2, 0, -1):
        q.append(fr.add(coeffs[i], fr.mul(z, q[-1])))
    return torch.stack(q[::-1])


def poly_long_div(dividend, divisor):
    """Schoolbook long division, remainder dropped (reference:
    polyLongDiv, poly.go:14-40). dividend (la, 8), divisor (lb, 8) with a
    nonzero top coefficient -> quotient (la-lb+1, 8). The outer loop is
    serial; each step subtracts q times the divisor from the whole window
    at once."""
    la, lb = dividend.shape[0], divisor.shape[0]
    if lb == 0:
        raise ValueError("empty divisor")
    if la < lb:
        return dividend[:0]
    if lb == 1:
        return fr.mul(dividend, fr.inv(divisor[0]))
    top_inv = fr.inv(divisor[-1])
    div_rest = divisor[:-1]
    rem = dividend.clone()
    qs = []
    for pos in range(la - 1, lb - 2, -1):
        q = fr.mul(rem[pos], top_inv)
        lo = pos - (lb - 1)
        rem[lo:pos] = fr.sub(rem[lo:pos], fr.mul(q.expand(div_rest.shape),
                                                 div_rest))
        rem[pos] = 0
        qs.append(q)
    return torch.stack(qs[::-1])


def poly_quotient_on_domain(fs, coeffs, z, y=None):
    """q(x) = (p(x) - y) / (x - z) through the evaluation domain: FFT,
    pointwise division, inverse FFT. Exact, so equal to poly_factor_div
    of p - y, for n a power of two and z off the n-th roots of unity.
    y = p(z) unless given. Returns (n-1, 8): the padded quotient's top
    coefficient is zero."""
    n = coeffs.shape[0]
    if y is None:
        y = eval_poly_at_parallel(coeffs, z)
    evals = fft(fs, coeffs)
    domain = fs.expanded_roots_of_unity[: n * (fs.max_width // n):
                                        fs.max_width // n]
    num = fr.sub(evals, y.expand(evals.shape))
    den = fr.sub(domain, z.expand(domain.shape))
    q = fft(fs, fr.mul(num, fr.inv(den)), inverse=True)
    return q[:-1]
