"""Kernels of the field-chain experiments (csrc/exp_field_kernels.cu), each
with its plain PyTorch version, and their host constants.

- `exp_mont_chain`: x <- REDC(x*b) `depth` times a lane, Fr or Fp, in
  variant A (field.cuh's CIOS product), B (separated operand scanning on a
  shared-memory accumulator) or C (REDC's by-constant passes on the tensor
  cores); replaces scripts/exp_montmul.py::run_variant.
- `exp_tc_mont_mul`: one Fp REDC(a*b) a lane on variant C's device code
  ("hybrid"), or its by-constant pass alone, x * n' mod R, on the tensor
  cores ("tc_pass") or the CUDA cores ("cc_pass"); replaces
  scripts/exp_mxu_mul.py::pallas_hybrid_mul_fn.
- `exp_op_chain`: `depth` applications a lane of one small Fp op (OPS);
  replaces scripts/exp_addsub.py::timed.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. Each launch adds one to the
wrapper's entry in `LAUNCHES` and to its case in `CASES`.

The plain versions work on int64 tensors of 16-bit limbs (field/limbs.py)
and each follows its kernel's algorithm: A the plain engine's product, B
operand scanning with one reduction row a limb, C and the tensor-core pass
the byte-Toeplitz products as an integer matrix product on the CPU. All
end on the canonical product, which is unique, so kernel and plain version
agree word for word.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from .. import build
from ..field import fp, fr, limbs
from ..field.kernels import check_words, stream_of
from ..field.limbs import LIMB_BITS, LIMB_MASK, FieldSpec

LAUNCHES = {"exp_mont_chain": 0, "exp_tc_mont_mul": 0, "exp_op_chain": 0}
# launches by case: "exp_mont_chain:Fp:C", "exp_tc_mont_mul:hybrid", ...
CASES: collections.Counter = collections.Counter()

VARIANTS = ("A", "B", "C")
MODES = ("hybrid", "tc_pass", "cc_pass")
# the six ops of scripts/exp_addsub.py, in the C entry point's order
OPS = ("mont_mul(x,c)", "mod_add(x,x)", "mod_sub(m,x)", "carry_fold",
       "geq+where", "cond_sub")
FP = fp.SPEC
SPECS = {"Fr": fr.SPEC, "Fp": fp.SPEC}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CASES.clear()


# ---- host constants ----
def toeplitz_bytes(c: int, in_digits: int, out_digits: int) -> np.ndarray:
    """(in_digits, out_digits) u8 matrix T with T[i, k] = byte k - i of c
    (0 for k < i): (byte digits of x) @ T = the byte-column sums of x*c,
    its first out_digits columns."""
    cb = [(c >> (8 * j)) & 0xFF for j in range(out_digits)]
    t = np.zeros((in_digits, out_digits), dtype=np.uint8)
    for i in range(in_digits):
        t[i, i:] = cb[:out_digits - i]
    return t


@functools.lru_cache(maxsize=None)
def toeplitz_pair(spec: FieldSpec):
    """The byte-Toeplitz matrices of REDC's two by-constant passes:
    n' (4N x 4N, for q = t_lo n' mod R) and m (4N x 8N, for q m)."""
    d = 4 * spec.n_words
    return (toeplitz_bytes(spec.nprime, d, d),
            toeplitz_bytes(spec.modulus, d, 2 * d))


@functools.lru_cache(maxsize=None)
def _toeplitz_tensors(spec: FieldSpec, device: torch.device):
    return tuple(torch.from_numpy(t).to(device) for t in toeplitz_pair(spec))


# ---- plain versions ----
def _exact(v: torch.Tensor) -> torch.Tensor:
    """Redundant non-negative limbs -> canonical limbs, mod 2^(16 len)."""
    return limbs.normalize(v)[0]


def _bytes(v: torch.Tensor) -> torch.Tensor:
    """Canonical 16-bit limbs (..., L) -> byte digits (..., 2L)."""
    return torch.stack((v & 0xFF, v >> 8), dim=-1).flatten(-2)


def _byte_columns(v: torch.Tensor, t: np.ndarray) -> torch.Tensor:
    """Byte-column sums of x*c: the digits of canonical limbs v times the
    Toeplitz matrix t of c, an int64 matrix product on the CPU."""
    d = _bytes(v)
    cols = d.cpu() @ torch.from_numpy(t.astype(np.int64))
    return cols.to(v.device)


def _limbs_of_columns(cols: torch.Tensor) -> torch.Tensor:
    """Byte-column sums (..., 2K) -> canonical 16-bit limbs (..., K), mod
    2^(16K)."""
    return _exact(cols[..., 0::2] + (cols[..., 1::2] << 8))


def _full_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b of canonical limbs (..., L) as canonical limbs (..., 2L)."""
    return _exact(torch.nn.functional.pad(limbs._product_cols(a, b), (0, 1)))


def _redc_sos(spec: FieldSpec, a, b) -> torch.Tensor:
    """Variant B's plain version: the full product, then one reduction
    row a 16-bit limb (q = t_i (-m^-1) mod 2^16, t += q m 2^(16i), t_i's
    carry into t_(i+1)), then the conditional subtraction."""
    c = limbs.consts(spec, a.device)
    L = c.L
    n0 = (-pow(spec.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    t = _full_product(limbs.words_to_limbs(a), limbs.words_to_limbs(b))
    for i in range(L):
        q = (t[..., i] * n0) & LIMB_MASK
        t[..., i:i + L] += q.unsqueeze(-1) * c.mod
        t[..., i + 1] += t[..., i] >> LIMB_BITS
    return limbs.limbs_to_words(limbs.canon(c, t[..., L:]))


def _redc_tc(spec: FieldSpec, a, b) -> torch.Tensor:
    """Variant C's plain version: t = a*b on the limb engine, q and q m on
    the byte-Toeplitz matrices, s = (t + q m) / R, the conditional
    subtraction."""
    c = limbs.consts(spec, a.device)
    L = c.L
    tq, tqm = toeplitz_pair(spec)
    t = _full_product(limbs.words_to_limbs(a), limbs.words_to_limbs(b))
    q = _limbs_of_columns(_byte_columns(t[..., :L], tq))
    qm = _limbs_of_columns(_byte_columns(q, tqm))
    s = _exact(t + qm)   # t + q m < 2 m R < R^2: no carry out
    return limbs.limbs_to_words(limbs.canon(c, s[..., L:]))


def _redc(spec: FieldSpec, variant: str, a, b) -> torch.Tensor:
    if variant == "A":
        return limbs.mont_mul_plain(spec, a, b)
    if variant == "B":
        return _redc_sos(spec, a, b)
    return _redc_tc(spec, a, b)


def exp_mont_chain_plain(spec: FieldSpec, a, b, variant: str,
                         depth: int) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"exp_mont_chain: variant {variant!r}")
    x = a
    for _ in range(depth):
        x = _redc(spec, variant, x, b)
    return x


def tc_pass_plain(spec: FieldSpec, x) -> torch.Tensor:
    """x * n' mod R on the byte-Toeplitz matrix of n'."""
    return limbs.limbs_to_words(_limbs_of_columns(
        _byte_columns(limbs.words_to_limbs(x), toeplitz_pair(spec)[0])))


def cc_pass_plain(spec: FieldSpec, x) -> torch.Tensor:
    """x * n' mod R on the limb engine's column sums."""
    c = limbs.consts(spec, x.device)
    cols = limbs._product_cols(limbs.words_to_limbs(x),
                               c.nprime.expand(x.shape[:-1] + (c.L,)))
    return limbs.limbs_to_words(_exact(cols[..., :c.L]))


def exp_tc_mont_mul_plain(a, b=None, mode: str = "hybrid") -> torch.Tensor:
    if mode == "hybrid":
        return _redc_tc(FP, a, b)
    if mode == "tc_pass":
        return tc_pass_plain(FP, a)
    if mode == "cc_pass":
        return cc_pass_plain(FP, a)
    raise ValueError(f"exp_tc_mont_mul: mode {mode!r}")


def _op_plain(op: str, x: torch.Tensor) -> torch.Tensor:
    """One application of an op of OPS on Fp words, as the kernel does it."""
    c = limbs.consts(FP, x.device)
    v = limbs.words_to_limbs(x)
    m = c.mod.expand(v.shape)
    if op == "mont_mul(x,c)":
        return limbs.mont_mul_plain(FP, x, FP.words([FP.nprime], x.device)[0])
    if op == "mod_add(x,x)":
        return limbs.add(FP, x, x)
    if op == "mod_sub(m,x)":
        d, borrow = limbs.normalize(m - v)          # m - x, + m if x > m
        d = torch.where((borrow < 0).unsqueeze(-1), _exact(d + c.mod), d)
        return limbs.limbs_to_words(d)
    if op == "carry_fold":
        return limbs.limbs_to_words(_exact(v))
    _, borrow = limbs.normalize(v - m)
    geq = (borrow >= 0).unsqueeze(-1)
    if op == "geq+where":
        return limbs.limbs_to_words(torch.where(geq, v, m))
    if op == "cond_sub":
        return limbs.limbs_to_words(torch.where(geq, _exact(v - m), v))
    raise ValueError(f"exp_op_chain: op {op!r}")


def exp_op_chain_plain(x, op: str, depth: int) -> torch.Tensor:
    if op not in OPS:
        raise ValueError(f"exp_op_chain: op {op!r}")
    for _ in range(depth):
        x = _op_plain(op, x)
    return x


# ---- wrappers ----
def _lanes(t: torch.Tensor, n_words: int, what: str) -> int:
    check_words(t, n_words, what)
    if t.dim() != 2:
        raise ValueError(f"{what}: expected (lanes, {n_words}) words")
    return t.shape[0]


def exp_mont_chain(spec: FieldSpec, a, b, variant: str,
                   depth: int) -> torch.Tensor:
    """x <- REDC(x*b) `depth` times from x = a, a lane each; a and b are
    (lanes, N) Fr or Fp words, canonical."""
    if a.device.type == "cpu":
        return exp_mont_chain_plain(spec, a, b, variant, depth)
    if variant not in VARIANTS:
        raise ValueError(f"exp_mont_chain: variant {variant!r}")
    N = spec.n_words
    n = _lanes(a, N, "exp_mont_chain")
    if b.shape != a.shape or b.device != a.device or b.dtype != a.dtype \
            or not b.is_contiguous():
        raise ValueError("exp_mont_chain: b must match a")
    if depth < 0:
        raise ValueError("exp_mont_chain: depth < 0")
    out = torch.empty_like(a)
    if n:
        tq, tqm = _toeplitz_tensors(spec, a.device)
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_mont_chain"] += 1
        CASES[f"exp_mont_chain:{spec.name}:{variant}"] += 1
        build.check(lib.kzg_exp_mont_chain(
            N, VARIANTS.index(variant), out.data_ptr(), a.data_ptr(),
            b.data_ptr(), tq.data_ptr(), tqm.data_ptr(), n, depth,
            stream_of(a)), "exp_mont_chain")
    return out


def exp_tc_mont_mul(a, b=None, mode: str = "hybrid") -> torch.Tensor:
    """Fp words (lanes, 12): REDC(a*b) with REDC's by-constant passes on
    the tensor cores ("hybrid"), or a * n' mod R on the tensor cores
    ("tc_pass") or the CUDA cores ("cc_pass"), a lane each."""
    if a.device.type == "cpu":
        return exp_tc_mont_mul_plain(a, b, mode)
    if mode not in MODES:
        raise ValueError(f"exp_tc_mont_mul: mode {mode!r}")
    n = _lanes(a, 12, "exp_tc_mont_mul")
    if mode == "hybrid":
        if b is None or b.shape != a.shape or b.device != a.device \
                or b.dtype != a.dtype or not b.is_contiguous():
            raise ValueError("exp_tc_mont_mul: b must match a")
    else:
        b = a
    out = torch.empty_like(a)
    if n:
        tq, tqm = _toeplitz_tensors(FP, a.device)
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_tc_mont_mul"] += 1
        CASES[f"exp_tc_mont_mul:{mode}"] += 1
        build.check(lib.kzg_exp_tc_mont_mul(
            MODES.index(mode), out.data_ptr(), a.data_ptr(), b.data_ptr(),
            tq.data_ptr(), tqm.data_ptr(), n, stream_of(a)),
            "exp_tc_mont_mul")
    return out


def exp_op_chain(x, op: str, depth: int) -> torch.Tensor:
    """`depth` applications of one op of OPS to Fp words (lanes, 12),
    canonical, a lane each."""
    if x.device.type == "cpu":
        return exp_op_chain_plain(x, op, depth)
    if op not in OPS:
        raise ValueError(f"exp_op_chain: op {op!r}")
    n = _lanes(x, 12, "exp_op_chain")
    if depth < 0:
        raise ValueError("exp_op_chain: depth < 0")
    out = torch.empty_like(x)
    if n:
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_op_chain"] += 1
        CASES[f"exp_op_chain:{op}"] += 1
        build.check(lib.kzg_exp_op_chain(OPS.index(op), out.data_ptr(),
                                         x.data_ptr(), n, depth,
                                         stream_of(x)), "exp_op_chain")
    return out


# ---- work counts, for the bounds ----
def pass_macs(spec: FieldSpec) -> tuple:
    """Byte multiply-adds a lane that REDC's two by-constant passes need:
    the band of each Toeplitz matrix, digit i times the constant's digit
    k - i for 0 <= k - i < 4N. q = t_lo n' mod R takes 4N(4N+1)/2 of them
    (only columns below 4N), q m takes (4N)^2."""
    d = 4 * spec.n_words
    return d * (d + 1) // 2, d * d
