"""The BLS12-381 base field Fp (381-bit) as batched 32-bit words.

An Fp batch is a torch.int32 tensor (..., 12) in Montgomery form
(R = 2^384), always fully reduced. `mul`/`sqr` run on kernel K1, add,
sub and neg on `fr_add_sub`, `pow_static` and `inv` on `fr_pow`;
`batch_inv` is the Montgomery trick on K1 scans and one `fr_pow`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs
from .constants import FP_MODULUS
from .kernels import fr_add_sub, fr_pow, mont_mul
from .limbs import FieldSpec

SPEC = FieldSpec(name="Fp", modulus=FP_MODULUS, n_words=12)
N_WORDS = SPEC.n_words


def add(a, b):
    return fr_add_sub(SPEC, "add", a, b)


def sub(a, b):
    return fr_add_sub(SPEC, "sub", a, b)


def neg(a):
    return fr_add_sub(SPEC, "neg", a)


def mul(a, b):
    return mont_mul(SPEC, a, b)


def sqr(a):
    return mont_mul(SPEC, a, a)


def pow_static(a, e: int):
    """a^e for a static exponent, lane-parallel: one fr_pow launch."""
    return fr_pow(SPEC, a, e)


def inv(a):
    """Fermat inverse a^(p-2), lane-parallel (square-and-multiply over
    the static exponent, MSB first); 0 -> 0."""
    return pow_static(a, SPEC.modulus - 2)


def batch_inv(a):
    """Inverse of every lane over all leading axes, 0 -> 0 (zero lanes do
    not poison the batch): the Montgomery trick, inclusive prefix and
    suffix products by doubling (2 log2 n K1 launches), one Fermat ladder
    for the total, and two products (kzg_tpu/field/limbs.py:389-422)."""
    n = a.numel() // N_WORDS
    if n == 0:
        return a.clone()
    flat = a.reshape(n, N_WORDS)
    zero = is_zero(flat)
    one = one_like(flat)
    x = select(zero, one, flat)
    pre = limbs.prefix_products(mul, x)
    suf = limbs.prefix_products(mul, x, reverse=True)
    total_inv = inv(pre[-1:])
    left = torch.cat((one[:1], pre[:-1]))
    right = torch.cat((suf[1:], one[:1]))
    out = mul(mul(left, right), total_inv[0])
    return select(zero, torch.zeros_like(out), out).reshape(a.shape)


eq = limbs.eq
is_zero = limbs.is_zero
select = limbs.select


def zero_like(a) -> torch.Tensor:
    return torch.zeros_like(a)


def one_like(a) -> torch.Tensor:
    return SPEC.words([SPEC.one_mont], a.device)[0].expand(a.shape).clone()


def zeros(shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (N_WORDS,), dtype=torch.int32,
                       device=device)


def from_int(values, device="cuda") -> torch.Tensor:
    return SPEC.encode(values, device)


def to_int(t) -> np.ndarray:
    return SPEC.decode(t)


def from_int_batch(ints, device="cuda") -> torch.Tensor:
    """N Python ints -> Montgomery words (N, 12): the canonical values'
    words times R^2 in one K1 launch (kzg_tpu/field/fp.py:83-95)."""
    raw = SPEC.words([int(v) % SPEC.modulus for v in ints], device)
    return mul(raw, SPEC.words([SPEC.r2], device)[0])


def to_int_batch(t) -> list:
    """Montgomery words (..., 12) -> flat list of canonical Python ints:
    one K1 product by 1, then the words' bytes."""
    canon = mul(t.reshape(-1, N_WORDS), SPEC.words([1], t.device)[0])
    rows = np.ascontiguousarray(canon.cpu().numpy().astype("<i4")).view(
        np.uint8).reshape(-1, 4 * N_WORDS)
    return [int.from_bytes(r.tobytes(), "little") for r in rows]
