"""Montgomery field elements as 32-bit words, and the plain int64 engine.

A batch of field elements is a ``torch.int32`` tensor ``(..., N)`` holding
the little-endian 32-bit words of the Montgomery form a*R mod m, with
R = 2^(32N): N = 8 for Fr (R = 2^256) and N = 12 for Fp (R = 2^384). That
is the same integer the JAX package stores as 2N 16-bit limbs, so moving a
value between the two is a repack (see ``kzg_tpu_torch.convert``). Values
are always fully reduced (< m), so equality is word equality.

The CUDA kernels do the arithmetic on words (csrc/field.cuh). This module
also holds their plain PyTorch reference: an int64 engine over 16-bit
limbs, exact because every limb product fits in 63 bits. Inside it values
are *redundant*: limbs may be negative or exceed 16 bits and the value may
lie anywhere in (-m, 2m); `canon` brings one back to canonical limbs.
Only the value mod m matters, so a chain of plain operations ends on the
same canonical words as the kernels, which reduce after every operation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in the 32-bit word layout."""

    name: str
    modulus: int
    n_words: int

    @property
    def n_limbs(self) -> int:
        return 2 * self.n_words

    @functools.cached_property
    def r(self) -> int:
        return 1 << (32 * self.n_words)

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, -1, self.modulus)

    @functools.cached_property
    def n0(self) -> int:
        """-m^-1 mod 2^32: the CIOS digit constant of the kernels."""
        return (-pow(self.modulus, -1, 1 << 32)) % (1 << 32)

    @functools.cached_property
    def nprime(self) -> int:
        """-m^-1 mod R: the full-width constant of the plain engine."""
        return (-pow(self.modulus, -1, self.r)) % self.r

    @functools.cached_property
    def r2(self) -> int:
        return self.r * self.r % self.modulus

    @functools.cached_property
    def one_mont(self) -> int:
        return self.r % self.modulus

    def to_mont_int(self, x: int) -> int:
        return (x % self.modulus) * self.r % self.modulus

    def from_mont_int(self, x: int) -> int:
        return x * self.r_inv % self.modulus

    def words(self, ints, device="cuda") -> torch.Tensor:
        """Iterable of non-negative ints < R -> raw int32 words (no
        Montgomery conversion)."""
        nb = 4 * self.n_words
        buf = b"".join(int(v).to_bytes(nb, "little") for v in ints)
        arr = np.frombuffer(buf, dtype="<i4").reshape(-1, self.n_words)
        return torch.from_numpy(arr.copy()).to(device)

    def encode(self, values, device="cuda") -> torch.Tensor:
        """Python int / nested list of ints -> Montgomery words (host)."""
        arr = np.asarray(values, dtype=object)
        flat = [self.to_mont_int(int(v)) for v in arr.reshape(-1)]
        out = self.words(flat, device)
        return out.reshape(arr.shape + (self.n_words,))

    def decode(self, t: torch.Tensor) -> np.ndarray:
        """Montgomery words -> object array of canonical Python ints."""
        arr = np.ascontiguousarray(
            t.detach().cpu().numpy().astype("<i4")).reshape(-1, self.n_words)
        rows = arr.view(np.uint8).reshape(-1, 4 * self.n_words)
        out = np.empty(rows.shape[0], dtype=object)
        for i, r in enumerate(rows):
            out[i] = self.from_mont_int(int.from_bytes(r.tobytes(), "little"))
        return out.reshape(tuple(t.shape[:-1]))


def int_to_limbs(value: int, n_limbs: int) -> list:
    return [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)]


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., N) -> int64 16-bit limbs (..., 2N)."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack((x & LIMB_MASK, x >> LIMB_BITS), dim=-1).flatten(-2)


def limbs_to_words(v: torch.Tensor) -> torch.Tensor:
    """Canonical int64 16-bit limbs (..., 2N) -> int32 words (..., N)."""
    x = v.unflatten(-1, (-1, 2))
    w = x[..., 0] | (x[..., 1] << LIMB_BITS)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


class _Consts:
    """Per-(field, device) constant tensors of the plain engine."""

    def __init__(self, spec: FieldSpec, device: torch.device):
        L = spec.n_limbs
        m = spec.modulus
        self.L = L

        def t(vals, dtype=torch.int64):
            return torch.tensor(vals, dtype=dtype, device=device)

        self.mod = t(int_to_limbs(m, L))
        self.nprime = t(int_to_limbs(spec.nprime, L))
        # 2^(16k) / m and 2^(16(k-L)) as float64: exact powers of two up
        # to the rounding of 1/m, enough for the quotient estimates below
        self.w_mod = t([float(1 << (LIMB_BITS * k)) / m for k in range(L)],
                       torch.float64)
        self.w_r = t([2.0 ** (LIMB_BITS * (k - L)) for k in range(L)],
                     torch.float64)


@functools.lru_cache(maxsize=None)
def consts(spec: FieldSpec, device: torch.device) -> _Consts:
    return _Consts(spec, torch.device(device))


def _product_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the schoolbook product: (..., La) x (..., Lb) ->
    (..., La+Lb-1), column k = sum_{i+j=k} a_i b_j. Row i of the outer
    product is shifted by i with one pad and reshape (a row padded to
    width P and read back at width P-1 moves one place per row)."""
    La, Lb = a.shape[-1], b.shape[-1]
    P = La + Lb
    p = a.unsqueeze(-1) * b.unsqueeze(-2)
    p = F.pad(p, (0, P - Lb)).flatten(-2)[..., : La * (P - 1)]
    return p.unflatten(-1, (La, P - 1)).sum(-2)


def _carry(v: torch.Tensor, steps: int, keep_top: bool) -> torch.Tensor:
    """`steps` carry-save passes: each limb keeps its low 16 bits and
    hands the (signed) rest to the next limb. keep_top=False drops what
    leaves the top limb (arithmetic mod 2^(16L)); keep_top=True keeps the
    top limb whole, so the value is unchanged."""
    for _ in range(steps):
        hi = v >> LIMB_BITS
        if keep_top:
            hi[..., -1] = 0
        v = v - (hi << LIMB_BITS) + F.pad(hi[..., :-1], (1, 0))
    return v


def mul_lazy(c: _Consts, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Redundant a*b*R^-1 mod m, value in (-m, 2m) (in practice within
    2^-20 m of [0, m)), limbs within a few units of [0, 2^16).

    Full-width Montgomery: T = a*b; q = -T*m^-1 mod R; (T + q*m)/R. The
    low half of T + q*m is an exact multiple of R, so its carry into the
    high half is the rounded float64 value of low/R. A quotient estimate
    k = floor(value/m), also in float64, then takes k*m off, which keeps
    every output small however large the inputs' sums were.
    Requires input limbs below ~2^22 in magnitude (column sums < 2^50)."""
    L = c.L
    T = _product_cols(a, b)                              # (..., 2L-1)
    tl = _carry(T[..., :L], 2, keep_top=False)
    q = _carry(_product_cols(tl, c.nprime)[..., :L], 3, keep_top=False)
    S = T + _product_cols(q, c.mod)
    low = (S[..., :L].to(torch.float64) * c.w_r).sum(-1)
    hi = F.pad(S[..., L:], (0, 1))
    hi[..., 0] += torch.round(low).to(torch.int64)
    k = torch.floor((hi.to(torch.float64) * c.w_mod).sum(-1)).to(torch.int64)
    return _carry(hi - k.unsqueeze(-1) * c.mod, 4, keep_top=True)


def normalize(v: torch.Tensor):
    """Exact sequential carry: -> (limbs in [0, 2^16), signed top carry).
    The carry runs over pairs of limbs as 32-bit digits, half as many
    sequential steps; limbs below 2^40 in magnitude keep every pair below
    2^57. The limb count must be even."""
    w = v[..., 0::2] + (v[..., 1::2] << LIMB_BITS)
    out = []
    carry = torch.zeros_like(w[..., 0])
    for k in range(w.shape[-1]):
        x = w[..., k] + carry
        out.append(x & 0xFFFFFFFF)
        carry = x >> 32
    n = torch.stack(out, dim=-1)
    return torch.stack((n & LIMB_MASK, n >> LIMB_BITS), dim=-1).flatten(-2), \
        carry


def canon(c: _Consts, v: torch.Tensor) -> torch.Tensor:
    """Redundant limbs with value in (-m, 2m) -> canonical limbs < m."""
    n, t = normalize(v)
    n, _ = normalize(n + (t < 0).unsqueeze(-1) * c.mod)   # now in [0, 2m)
    d, borrow = normalize(n - c.mod)
    return torch.where((borrow < 0).unsqueeze(-1), n, d)


def canon_wide(c: _Consts, v: torch.Tensor) -> torch.Tensor:
    """Redundant limbs with a value a few times m either side of 0 ->
    canonical limbs < m: a float64 quotient estimate k = floor(v/m), off
    by at most one, takes k*m off (as `mul_lazy` does) before `canon`."""
    k = torch.floor((v.to(torch.float64) * c.w_mod).sum(-1)).to(torch.int64)
    return canon(c, v - k.unsqueeze(-1) * c.mod)


# ---- plain canonical ops on words (the engine behind fr/fp) ----
def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Plain REDC(a*b) on words; b broadcasts against a."""
    c = consts(spec, a.device)
    a, b = torch.broadcast_tensors(a, b)
    return limbs_to_words(
        canon(c, mul_lazy(c, words_to_limbs(a), words_to_limbs(b))))


def add(spec: FieldSpec, a, b):
    c = consts(spec, a.device)
    return limbs_to_words(canon(c, words_to_limbs(a) + words_to_limbs(b)))


def sub(spec: FieldSpec, a, b):
    c = consts(spec, a.device)
    return limbs_to_words(canon(c, words_to_limbs(a) - words_to_limbs(b)))


def neg(spec: FieldSpec, a):
    c = consts(spec, a.device)
    return limbs_to_words(canon(c, -words_to_limbs(a)))


def eq(a, b) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return (a == b).all(-1)


def is_zero(a) -> torch.Tensor:
    return (a == 0).all(-1)


def select(mask, a, b):
    """where(mask, a, b) with mask shaped like the batch."""
    return torch.where(mask.unsqueeze(-1), a, b)


# ---- exponentiation and scans over a field product `mul` (the plain
# versions of fr_pow and fr_batch_inv, field/kernels.py;
# kzg_tpu/field/limbs.py:353-422) ----
def pow_static(spec: FieldSpec, mul, a, exponent: int):
    """a^exponent for a static exponent: square-and-multiply MSB first,
    branching in Python on each bit (square always, multiply on a 1 bit).
    The values equal the JAX ladder's, which multiplies on every bit and
    selects."""
    if exponent == 0:
        return spec.words([spec.one_mont], a.device)[0].expand(a.shape) \
            .contiguous()
    acc = a
    for bit in bin(exponent)[3:]:
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def prefix_products(mul, x, reverse: bool = False):
    """Inclusive prefix (or, reversed, suffix) products along axis 0 by
    Hillis-Steele doubling: step d multiplies every lane by the lane d
    before it (after it), so log2(n) products in all, each over the whole
    batch."""
    n = x.shape[0]
    d = 1
    while d < n:
        if reverse:
            x = torch.cat((mul(x[:-d], x[d:]), x[n - d:]))
        else:
            x = torch.cat((x[:d], mul(x[d:], x[:-d])))
        d *= 2
    return x
