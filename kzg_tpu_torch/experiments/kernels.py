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
- `exp_tuple_chain`: `depth` iterations a lane of the 7-product body with
  the carry (f, g, c), in a body of BODIES and a product of PRODUCTS;
  replaces scripts/exp_ab_mul.py::run and scripts/exp_carry.py::make.
- `exp_ext_chain`: the 8-product body in the 13-word lazy domain on three
  point coordinates, with 0-12 extra ops on c (EXT_CASES); replaces
  scripts/exp_truth.py::build and scripts/exp_addcost.py::variant.
- `exp_ext_body`: the 7-product body (EXT_BODIES: with to_ext and from_ext,
  "conv", or on the padded words with the modulus from a device-memory
  context, "ctx") and two raw product chains ("indep8", "dblshape") in the
  13-word lazy domain; replaces the rest of scripts/exp_bisect.py::variant
  and scripts/exp_lazyops.py::mulref. exp_tuple_chain's bodies transp,
  serial8 and serial1 and its product sqr12 (TUPLE_CASES_X789) replace
  exp_bisect.py's transp, exp_width.py::serial8 and
  exp_pointops.py::mul_chain and ::sqr_chain.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. Each launch adds one to the
wrapper's entry in `LAUNCHES` and to its case in `CASES`.

The plain versions work on int64 tensors of 16-bit limbs (field/limbs.py)
and each follows its kernel's algorithm: A the plain engine's product, B
operand scanning with one reduction row a limb, C and the tensor-core pass
the byte-Toeplitz products as an integer matrix product on the CPU. All
end on the canonical product, which is unique, so kernel and plain version
agree word for word. The lazy products (REDC with no final conditional
subtraction) end on the integer (T + q m) / R, which is unique too.
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

LAUNCHES = {"exp_mont_chain": 0, "exp_tc_mont_mul": 0, "exp_op_chain": 0,
            "exp_tuple_chain": 0, "exp_ext_chain": 0, "exp_ext_body": 0}
# launches by case: "exp_mont_chain:Fp:C", "exp_tc_mont_mul:hybrid",
# "exp_tuple_chain:tuple3:lazy13", "exp_ext_chain:subs12", ...
CASES: collections.Counter = collections.Counter()

VARIANTS = ("A", "B", "C")
MODES = ("hybrid", "tc_pass", "cc_pass")
# the six ops of scripts/exp_addsub.py, in the C entry point's order
OPS = ("mont_mul(x,c)", "mod_add(x,x)", "mod_sub(m,x)", "carry_fold",
       "geq+where", "cond_sub")
FP = fp.SPEC
SPECS = {"Fr": fr.SPEC, "Fp": fp.SPEC}
# the 7-product body's products and bodies, in the C entry point's order,
# and the (body, product) pairs the library holds
PRODUCTS = ("mont12", "lazy12", "lazy13", "lazy16")
# and the symmetric square (X9), the C entry point's product 4
PRODUCT_CODES = PRODUCTS + ("sqr12",)
PRODUCT_WORDS = {"mont12": 12, "lazy12": 12, "lazy13": 13, "lazy16": 16,
                 "sqr12": 12}
BODIES = ("tuple3", "single", "serial", "serial8", "serial1", "transp")
TUPLE_CASES = (tuple(("tuple3", p) for p in PRODUCTS)
               + (("single", "mont12"),)
               + tuple(("serial", p) for p in PRODUCTS))
# the cases of X7 (transp: tuple3 on three coordinates read word-major),
# X8 (eight squarings a step, 256 threads a block) and X9 (one product a
# step, mul<12> or the symmetric square)
TUPLE_CASES_X789 = (("transp", "lazy13"), ("serial8", "mont12"),
                    ("serial1", "mont12"), ("serial1", "sqr12"))
# the serial bodies' products a step
SERIAL_STEPS = {"serial": 7, "serial8": 8, "serial1": 1}
# the 8-product body's extra ops: the C op of each kind (fold is the lazy
# add: on 32-bit words the carry lives inside the add.cc chain), and the
# script's six variants (kind, extras an iteration)
EXT_OPS = {"adds": 0, "subs": 1, "fold": 0, "raw": 2}
EXT_CASES = (("adds", 0), ("adds", 4), ("adds", 12), ("subs", 12),
             ("fold", 12), ("raw", 12))
# cases the scripts lack, for checks only: subs1 (subs12 leaves c = K m
# from its third extra on, so all its outputs are 0)
EXT_CHECK_CASES = (("subs", 1),)
# exp_ext_body's bodies, in the C entry point's order
EXT_BODIES = ("conv", "ctx", "indep8", "dblshape")
# the lazy domain of the 8-product body: 13 words, R_ext = 2^416; to_ext
# multiplies by C_IN (aR -> aR_ext), from_ext by C_OUT; the lazy sub
# offsets by K m
EXT_WORDS = 13
EXT_C_IN = pow(2, 2 * 32 * EXT_WORDS - 384, fp.SPEC.modulus)
EXT_C_OUT = pow(2, 384, fp.SPEC.modulus)
EXT_K = 64
EXT_KM = EXT_K * fp.SPEC.modulus


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


def _up(v: torch.Tensor, d: int) -> torch.Tensor:
    """Limbs move d places up; the top d drop out."""
    return torch.nn.functional.pad(v[..., :-d], (d, 0))


def _fold(v: torch.Tensor, folds: int) -> torch.Tensor:
    """Non-negative limbs -> canonical 16-bit limbs, mod 2^(16 len):
    `folds` carry-save folds, after which every limb must be below
    2^17 - 1 (none for a sum of two canonical limbs, one for limbs below
    2^32, two below 2^47, three below 2^63), then a Kogge-Stone carry
    lookahead, as the TPU's _carry_fold."""
    for _ in range(folds):
        v = (v & LIMB_MASK) + _up(v >> LIMB_BITS, 1)
    g = v >> LIMB_BITS
    p = (v == LIMB_MASK).to(v.dtype)
    d = 1
    while d < v.shape[-1]:
        g = g | (p & _up(g, d))
        p = p & _up(p, d)
        d *= 2
    return (v + _up(g, 1)) & LIMB_MASK


@functools.lru_cache(maxsize=None)
def _lazy_consts(n_words: int, device: torch.device):
    """Limbs of p, -p^-1 mod 2^(32 N) and 2^(16 (L+1)) - p at L = 2N (the
    last one L + 1 limbs: the conditional subtraction's complement)."""
    L, m = 2 * n_words, FP.modulus
    r = 1 << (32 * n_words)

    def t(v, n):
        return torch.tensor(limbs.int_to_limbs(v, n), dtype=torch.int64,
                            device=device)

    return t(m, L), t((-pow(m, -1, r)) % r, L), t((r << 16) - m, L + 1)


def _redc_columns(t: torch.Tensor, n_words: int) -> torch.Tensor:
    """(T + q p) / R mod R from T's column sums t (..., 2L - 1), each
    below 2^38, R = 2^(32 N), L = 2N: q = -T p^-1 mod R."""
    mod, npr, _ = _lazy_consts(n_words, t.device)
    L = 2 * n_words
    cols = limbs._product_cols
    # T's column sums stand for T: their low L columns are T mod R up to
    # multiples of R, which q does not see
    t = torch.nn.functional.pad(t, (0, 1))
    q = _fold(cols(t[..., :L], npr)[..., :L], 3)        # sums below 2^59
    s = _fold(t + torch.nn.functional.pad(cols(q, mod), (0, 1)), 2)
    return s[..., L:]


def lazy_mul_limbs(a: torch.Tensor, b: torch.Tensor,
                   n_words: int) -> torch.Tensor:
    """REDC(a b) over R = 2^(32 N) with no final conditional subtraction:
    (T + q p) / R mod R, T = a b, q = -T p^-1 mod R, on canonical limbs
    (..., 2N), as the kernels' lazy products. T + q p < R^2 for every
    operand pair of the bodies."""
    return _redc_columns(limbs._product_cols(a, b), n_words)


def sym_square_columns(a: torch.Tensor) -> torch.Tensor:
    """Column sums of a*a by the symmetric product, as sqr12 forms it:
    each a_i a_j with i < j once, doubled, then the squares a_i^2."""
    L = a.shape[-1]
    upper = torch.triu(a.unsqueeze(-1) * a.unsqueeze(-2), diagonal=1)
    cols = torch.zeros(a.shape[:-1] + (2 * L - 1,), dtype=a.dtype,
                       device=a.device)
    for i in range(L):
        cols[..., i:i + L] += upper[..., i, :]
    cols = 2 * cols
    cols[..., 0::2] += a * a
    return cols


def cond_sub_limbs(v: torch.Tensor, n_words: int) -> torch.Tensor:
    """v - p if v >= p else v, on canonical limbs (..., 2N) below 2p: the
    complement sum's top limb is 0 where v >= p."""
    comp = _lazy_consts(n_words, v.device)[2]
    L = 2 * n_words
    d = _fold(torch.nn.functional.pad(v, (0, 1)) + comp, 0)
    return torch.where((d[..., L] == 0).unsqueeze(-1), d[..., :L], v)


def _tuple_product(product: str):
    n = PRODUCT_WORDS[product]
    if product == "mont12":
        return lambda a, b: cond_sub_limbs(lazy_mul_limbs(a, b, n), n)
    if product == "sqr12":
        return lambda a, b: cond_sub_limbs(
            _redc_columns(sym_square_columns(a), n), n)
    return lambda a, b: lazy_mul_limbs(a, b, n)


def _check_tuple_case(body: str, product: str) -> None:
    if (body, product) not in TUPLE_CASES + TUPLE_CASES_X789:
        raise ValueError(f"exp_tuple_chain: case {body!r}, {product!r}")


def _padded(x: torch.Tensor, n_words: int) -> torch.Tensor:
    """(lanes, 12) words -> limbs zero-padded to n_words words."""
    v = limbs.words_to_limbs(x)
    return torch.nn.functional.pad(v, (0, 2 * n_words - v.shape[-1]))


def exp_tuple_chain_plain(x, body: str, product: str,
                          depth: int) -> torch.Tensor:
    """The 7-product body on the limb engine: the kernel's arithmetic, one
    value a lane at its product's width, stored as its low 12 words
    (transp: x a (3, 12, lanes) word-major stack, f out as (12, lanes))."""
    _check_tuple_case(body, product)
    M = _tuple_product(product)
    n = PRODUCT_WORDS[product]
    if body == "transp":
        v, y, z = (_padded(c.T, n) for c in x)
    else:
        v = y = z = _padded(x, n)
    if body in SERIAL_STEPS:
        for _ in range(SERIAL_STEPS[body] * depth):
            v = M(v, v)
    else:       # tuple3, single and transp compute the same words
        for _ in range(depth):
            a, b, c = M(v, y), M(y, z), M(z, v)
            d, e = M(a, b), M(b, c)
            v, y, z = M(d, e), M(e, a), c
    out = limbs.limbs_to_words(v[..., :24])
    return out.T.contiguous() if body == "transp" else out


@functools.lru_cache(maxsize=None)
def _ext_consts(device: torch.device):
    """13-word limbs of C_IN, C_OUT and K m + 1 (the lazy sub's offset and
    its complement's one)."""
    return tuple(torch.tensor(limbs.int_to_limbs(c, 2 * EXT_WORDS),
                              dtype=torch.int64, device=device)
                 for c in (EXT_C_IN, EXT_C_OUT, EXT_KM + 1))


def _ext_op_plain(kind: str, a: torch.Tensor, b: torch.Tensor):
    """One extra op on 13-word limbs, mod 2^416: the lazy add (adds,
    fold), a + (K m - b) as a + K m + 1 + (the limbs' complement of b)
    (subs), or per 32-bit word a + b with the carry out of each word
    dropped (raw)."""
    if kind in ("adds", "fold"):
        return _fold(a + b, 0)
    if kind == "subs":
        return _fold(a + _ext_consts(a.device)[2] + (LIMB_MASK - b), 1)
    s = a + b
    w = (s[..., 0::2] + (s[..., 1::2] << LIMB_BITS)) & 0xFFFFFFFF
    return torch.stack((w & LIMB_MASK, w >> LIMB_BITS), dim=-1).flatten(-2)


def _check_ext_case(kind: str, nextra: int) -> None:
    if (kind, nextra) not in EXT_CASES + EXT_CHECK_CASES:
        raise ValueError(f"exp_ext_chain: case {kind!r}, {nextra!r}")


def exp_ext_chain_plain(x, y, z, kind: str, nextra: int, depth: int):
    """The 8-product body in the 13-word lazy domain on the limb engine:
    to_ext, `depth` iterations, from_ext (module docstring)."""
    _check_ext_case(kind, nextra)
    c_in, c_out, _ = _ext_consts(x.device)

    def M(a, b):
        return lazy_mul_limbs(a, b, EXT_WORDS)

    def to_ext(w):
        return M(_padded(w, EXT_WORDS), c_in)

    def from_ext(v):
        return limbs.limbs_to_words(
            cond_sub_limbs(M(v, c_out), EXT_WORDS)[..., :24])

    x, y, z = to_ext(x), to_ext(y), to_ext(z)
    for _ in range(depth):
        a, b, c = M(x, y), M(y, z), M(z, x)
        for j in range(nextra):
            c = _ext_op_plain(kind, (a, b, c)[j % 3], c)
        d, e = M(a, b), M(b, c)
        x, y = M(d, e), M(e, a)
        z = M(x, y)
    return from_ext(x), from_ext(y), from_ext(z)


def _check_ext_body(body: str) -> None:
    if body not in EXT_BODIES:
        raise ValueError(f"exp_ext_body: body {body!r}")


def exp_ext_body_plain(x, y, z, body: str, depth: int) -> tuple:
    """exp_ext_body on the limb engine (module docstring); indep8's five
    products that feed nothing are not computed."""
    _check_ext_body(body)
    c_in, c_out, _ = _ext_consts(x.device)

    def M(a, b):
        return lazy_mul_limbs(a, b, EXT_WORDS)

    if body == "ctx":
        v = [_padded(c, EXT_WORDS) for c in (x, y, z)]
    else:
        v = [M(_padded(c, EXT_WORDS), c_in) for c in (x, y, z)]
    for _ in range(depth):
        x_, y_, z_ = v
        if body in ("conv", "ctx"):
            a, b, c = M(x_, y_), M(y_, z_), M(z_, x_)
            d, e = M(a, b), M(b, c)
            v = [M(d, e), M(e, a), c]
        elif body == "indep8":
            v = [M(x_, y_), M(y_, z_), M(z_, x_)]
        else:
            t0, t1, t2 = M(y_, y_), M(y_, z_), M(z_, z_)
            c = M(M(t2, t0), M(t1, t2))
            d = M(c, t0)
            v = [c, d, M(d, x_)]
    if body == "ctx":
        return tuple(limbs.limbs_to_words(c[..., :24]) for c in v)
    return tuple(limbs.limbs_to_words(cond_sub_limbs(
        M(c, c_out), EXT_WORDS)[..., :24]) for c in v)


@functools.lru_cache(maxsize=None)
def _ext_ctx(device: torch.device) -> torch.Tensor:
    """exp_ext_body's ctx context: the modulus in 14 words, then n0."""
    m = FP.modulus
    n0 = (-pow(m, -1, 1 << 32)) % (1 << 32)
    words = [(m >> (32 * k)) & 0xFFFFFFFF for k in range(14)] + [n0]
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32),
                        device=device)


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


def exp_tuple_chain(x, body: str, product: str, depth: int) -> torch.Tensor:
    """`depth` iterations a lane of a=M(x,y) b=M(y,z) c=M(z,x) d=M(a,b)
    e=M(b,c) f=M(d,e) g=M(e,a), carry (f, g, c), from x = y = z = the
    input, or a serial body of SERIAL_STEPS products; returns f. x:
    (lanes, 12) Fp words, below p for mont12 and sqr12 and below 2p for
    the lazy products; for transp a (3, 12, lanes) word-major stack of
    three coordinates, f returned as (12, lanes)."""
    if x.device.type == "cpu":
        return exp_tuple_chain_plain(x, body, product, depth)
    _check_tuple_case(body, product)
    if body == "transp":
        if x.dtype != torch.int32 or x.dim() != 3 \
                or tuple(x.shape[:2]) != (3, 12) or not x.is_contiguous():
            raise ValueError("exp_tuple_chain: transp takes contiguous "
                             "int32 (3, 12, lanes) words")
        n = x.shape[2]
    else:
        n = _lanes(x, 12, "exp_tuple_chain")
    if depth < 0:
        raise ValueError("exp_tuple_chain: depth < 0")
    out = torch.empty_like(x[0] if body == "transp" else x)
    if n:
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_tuple_chain"] += 1
        CASES[f"exp_tuple_chain:{body}:{product}"] += 1
        build.check(lib.kzg_exp_tuple_chain(
            BODIES.index(body), PRODUCT_CODES.index(product), out.data_ptr(),
            x.data_ptr(), n, depth, stream_of(x)), "exp_tuple_chain")
    return out


def exp_ext_chain(x, y, z, kind: str, nextra: int, depth: int) -> tuple:
    """to_ext, `depth` iterations a lane of the 8-product body with
    `nextra` extra ops of `kind` on c, from_ext: (lanes, 12) canonical Fp
    Montgomery words of three coordinates in and out."""
    if x.device.type == "cpu":
        return exp_ext_chain_plain(x, y, z, kind, nextra, depth)
    _check_ext_case(kind, nextra)
    n = _lanes(x, 12, "exp_ext_chain")
    for t in (y, z):
        if t.shape != x.shape or t.device != x.device \
                or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("exp_ext_chain: y and z must match x")
    if depth < 0:
        raise ValueError("exp_ext_chain: depth < 0")
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if n:
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_ext_chain"] += 1
        CASES[f"exp_ext_chain:{kind}{nextra}"] += 1
        build.check(lib.kzg_exp_ext_chain(
            EXT_OPS[kind], nextra, *(o.data_ptr() for o in outs),
            x.data_ptr(), y.data_ptr(), z.data_ptr(), n, depth,
            stream_of(x)), "exp_ext_chain")
    return outs


def exp_ext_body(x, y, z, body: str, depth: int) -> tuple:
    """`depth` iterations a lane of one of EXT_BODIES in the 13-word lazy
    domain on (lanes, 12) Fp Montgomery words of three coordinates; conv,
    indep8 and dblshape take them through to_ext and from_ext, ctx takes
    the zero-padded words and returns each value's low 12 words."""
    if x.device.type == "cpu":
        return exp_ext_body_plain(x, y, z, body, depth)
    _check_ext_body(body)
    n = _lanes(x, 12, "exp_ext_body")
    for t in (y, z):
        if t.shape != x.shape or t.device != x.device \
                or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("exp_ext_body: y and z must match x")
    if depth < 0:
        raise ValueError("exp_ext_body: depth < 0")
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if n:
        ctx = _ext_ctx(x.device)
        lib = build.library("exp_field_kernels")
        LAUNCHES["exp_ext_body"] += 1
        CASES[f"exp_ext_body:{body}"] += 1
        build.check(lib.kzg_exp_ext_body(
            EXT_BODIES.index(body), *(o.data_ptr() for o in outs),
            x.data_ptr(), y.data_ptr(), z.data_ptr(), ctx.data_ptr(), n,
            depth, stream_of(x)), "exp_ext_body")
    return outs


# ---- Python-int models of the lazy arithmetic ----
@functools.lru_cache(maxsize=None)
def _neg_pinv(n_words: int) -> int:
    r = 1 << (32 * n_words)
    return (-pow(FP.modulus, -1, r)) % r


def redc_int(t: int, n_words: int) -> int:
    """(t + q p) / R mod R with q = -t p^-1 mod R, R = 2^(32 N): REDC with
    no conditional subtraction, the words past N dropped as the kernels
    drop them."""
    shift = 32 * n_words
    mask = (1 << shift) - 1
    q = (t * _neg_pinv(n_words)) & mask
    return ((t + q * FP.modulus) >> shift) & mask


def raw_add_int(a: int, b: int, n_words: int) -> int:
    """a + b per 32-bit word, the carry out of each word dropped."""
    mask = 0xFFFFFFFF
    return sum((((a >> s) & mask) + ((b >> s) & mask) & mask) << s
               for s in range(0, 32 * n_words, 32))


# ---- work counts, for the bounds ----
def pass_macs(spec: FieldSpec) -> tuple:
    """Byte multiply-adds a lane that REDC's two by-constant passes need:
    the band of each Toeplitz matrix, digit i times the constant's digit
    k - i for 0 <= k - i < 4N. q = t_lo n' mod R takes 4N(4N+1)/2 of them
    (only columns below 4N), q m takes (4N)^2."""
    d = 4 * spec.n_words
    return d * (d + 1) // 2, d * d
