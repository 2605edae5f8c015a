"""Field kernels K1 (`mont_mul`, and its `fr_scale` exit form), K2
(`fr_butterfly_stage`), `fr_dif_stage`, `butterfly` and the digit
recoding `fr_signed_windows` (csrc/fr_kernels.cu), and the routes of K1,
K2 and `fr_dif_stage` (csrc/fr_route_kernels.cu): `fr_add_sub`, `fr_pow`,
`fr_batch_inv`, `fr_fft_block`, `fr_das_block` and `fr_zero_poly_leaves`,
each with its plain PyTorch version.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises. Each launch adds one to the
wrapper's entry in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build
from . import limbs
from .constants import FR_MODULUS
from .limbs import FieldSpec

LAUNCHES = {"mont_mul": 0, "fr_scale": 0, "fr_butterfly_stage": 0,
            "fr_dif_stage": 0, "butterfly": 0, "fr_signed_windows": 0,
            "fr_add_sub": 0, "fr_pow": 0, "fr_batch_inv": 0,
            "fr_fft_block": 0, "fr_das_block": 0,
            "fr_zero_poly_leaves": 0}

FR_WORDS = 8
FR = FieldSpec(name="Fr", modulus=FR_MODULUS, n_words=FR_WORDS)
SIGNED_WINDOWS = 64
# bias for signed-window recoding: 63 low nibbles of 8 (top nibble 0)
_SIGNED_WINDOW_BIAS = int("8" * 63, 16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_words(t: torch.Tensor, n_words: int, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.shape[-1] != n_words:
        raise ValueError(f"{what}: last dim {t.shape[-1]} != {n_words}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_mont_mul(spec: FieldSpec, a, b, what: str) -> torch.Tensor:
    """REDC(a*b) on the card; b is (..., N) like a, or one element (N,)."""
    N = spec.n_words
    check_words(a, N, what)
    check_words(b, N, what)
    if b.device != a.device:
        raise ValueError(f"{what}: operands on different devices")
    bcast = b.dim() == 1
    if not bcast and b.shape != a.shape:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} {tuple(b.shape)}")
    out = torch.empty_like(a)
    n = a.numel() // N
    if n:
        lib = build.library("fr_kernels")
        LAUNCHES[what] += 1
        build.check(lib.kzg_mont_mul(N, out.data_ptr(), a.data_ptr(),
                                     b.data_ptr(), n, int(bcast),
                                     stream_of(a)), what)
    return out


def mont_mul_plain(spec: FieldSpec, a, b) -> torch.Tensor:
    return limbs.mont_mul_plain(spec, a, b)


def mont_mul(spec: FieldSpec, a, b) -> torch.Tensor:
    """K1: elementwise REDC(a*b) for Fr or Fp words (replaces
    kzg_tpu/field/pallas_kernels.py::_mul_fn). a and b broadcast; on the
    card the broadcast is materialised unless b is one element."""
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if b.dim() == 1 and a.shape == shape:
        bb = b
    else:
        bb = b.expand(shape).contiguous()
    aa = a.expand(shape).contiguous()
    return _launch_mont_mul(spec, aa, bb, "mont_mul")


def fr_scale_plain(spec: FieldSpec, x, c) -> torch.Tensor:
    return limbs.mont_mul_plain(spec, x, c)


def fr_scale(spec: FieldSpec, x, c) -> torch.Tensor:
    """Exit of an inverse FFT: x * c for one broadcast Montgomery constant
    c (N,), canonical (K1 under its own count; replaces
    kzg_tpu/field/pallas_kernels.py::_canon_scale_fn)."""
    if x.device.type == "cpu":
        return fr_scale_plain(spec, x, c)
    if c.dim() != 1:
        raise ValueError("fr_scale: c must be one element (N,)")
    return _launch_mont_mul(spec, x, c, "fr_scale")


def butterfly_plain(spec: FieldSpec, a, b, tw):
    a, b, tw = torch.broadcast_tensors(a, b, tw)
    t = limbs.mont_mul_plain(spec, b, tw)
    return limbs.add(spec, a, t), limbs.sub(spec, a, t)


def butterfly(spec: FieldSpec, a, b, tw):
    """The fused butterfly (a + b*tw, a - b*tw) for Fr or Fp words, tw
    broadcast against the batch (replaces
    kzg_tpu/field/pallas_kernels.py::_butterfly_fn). On the card a and b
    are materialised at the broadcast shape, and tw too unless it is one
    element (N,); the kernel reads and writes 16 bytes at a time, so every
    operand must start on a 16-byte boundary."""
    if a.device.type == "cpu":
        return butterfly_plain(spec, a, b, tw)
    N = spec.n_words
    shape = torch.broadcast_shapes(a.shape, b.shape, tw.shape)
    aa = a.expand(shape).contiguous()
    bb = b.expand(shape).contiguous()
    bcast = tw.dim() == 1
    ww = tw if bcast else tw.expand(shape).contiguous()
    for t in (aa, bb, ww):
        check_words(t, N, "butterfly")
        if t.device != aa.device:
            raise ValueError("butterfly: operands on different devices")
        if t.data_ptr() % 16:
            raise ValueError("butterfly: operand not 16-byte aligned")
    hi, lo = torch.empty_like(aa), torch.empty_like(aa)
    n = aa.numel() // N
    if n:
        lib = build.library("fr_kernels")
        LAUNCHES["butterfly"] += 1
        build.check(lib.kzg_butterfly(N, hi.data_ptr(), lo.data_ptr(),
                                      aa.data_ptr(), bb.data_ptr(),
                                      ww.data_ptr(), n, int(bcast),
                                      stream_of(aa)), "butterfly")
    return hi, lo


def _halves(x, log_half: int):
    """(batch, n, 8) -> the a and b halves of every group of width
    m = 2^(log_half+1), each (batch, n/m, m/2, 8)."""
    batch, n, N = x.shape
    half = 1 << log_half
    xs = x.reshape(batch, n // (2 * half), 2, half, N)
    return xs[:, :, 0], xs[:, :, 1]


def _merged(hi, lo, shape):
    return torch.stack((hi, lo), dim=2).reshape(shape)


def _twiddles(roots, log_half: int, stride: int, offset):
    """roots[offset + j * stride] for j < 2^log_half, shaped to broadcast
    against a stage's halves: (half, N), or (rows, 1, half, N) for an
    int64 tensor `offset` of one offset a row."""
    half = 1 << log_half
    if torch.is_tensor(offset):
        steps = torch.arange(half, device=roots.device) * stride
        return roots[offset[:, None] + steps][:, None]
    return roots[offset: offset + half * stride: stride]


def fr_butterfly_stage_plain(spec: FieldSpec, x, roots, log_half: int,
                             stride: int, offset=0) -> torch.Tensor:
    """One DIT stage over x (batch, n, 8): within each group of
    m = 2^(log_half+1), position j pairs with j + m/2 and twiddle
    roots[offset + j * stride]; hi = a + b*tw, lo = a - b*tw. `offset`
    is an int, or an int64 tensor (batch,) of one offset a row (the
    tiles of `fr_fft_block_plain`). Returns a new tensor."""
    a, b = _halves(x, log_half)
    if torch.is_tensor(offset) or log_half > 0 or offset:
        tw = _twiddles(roots, log_half, stride, offset)
        b = limbs.mont_mul_plain(spec, b, tw.expand(b.shape))
    return _merged(limbs.add(spec, a, b), limbs.sub(spec, a, b), x.shape)


def _check_stage(what: str, x, roots, log_half: int, last_index: int):
    """Validate a stage's operands; -> log2 n."""
    check_words(x, FR_WORDS, what)
    check_words(roots, FR_WORDS, what)
    if x.dim() != 3 or roots.device != x.device:
        raise ValueError(f"{what}: x must be (batch, n, 8) and roots on "
                         "its device")
    n = x.shape[1]
    log_n = n.bit_length() - 1
    if n != 1 << log_n or not 0 <= log_half < log_n:
        raise ValueError(f"{what}: bad width or stage")
    if not 0 <= last_index < roots.shape[0]:
        raise ValueError(f"{what}: twiddle index out of range")
    return log_n


def fr_butterfly_stage(spec: FieldSpec, x, roots, log_half: int,
                       stride: int, offset: int = 0) -> torch.Tensor:
    """K2: one radix-2 DIT stage of canonical Fr words, in place on x
    (batch, n, 8), which is returned (replaces
    kzg_tpu/field/pallas_kernels.py::_butterfly_lazy_fn). The twiddle of
    position j is roots[offset + j * stride]; a stage 2 wide with offset
    0 has twiddle roots[0] = 1 and skips the multiply."""
    if x.device.type == "cpu":
        x.copy_(fr_butterfly_stage_plain(spec, x, roots, log_half, stride,
                                         offset))
        return x
    log_n = _check_stage("fr_butterfly_stage", x, roots, log_half,
                         offset + ((1 << log_half) - 1) * stride)
    total = x.shape[0] * x.shape[1] // 2
    if total:
        lib = build.library("fr_kernels")
        LAUNCHES["fr_butterfly_stage"] += 1
        build.check(lib.kzg_fr_butterfly_stage(
            x.data_ptr(), roots.data_ptr(), log_n, log_half, stride, offset,
            total, stream_of(x)), "fr_butterfly_stage")
    return x


def fr_dif_stage_plain(spec: FieldSpec, x, roots, log_half: int,
                       stride: int, offset=0) -> torch.Tensor:
    """One DIF stage over x (batch, n, 8): within each group of
    m = 2^(log_half+1), position j pairs with j + m/2;
    hi = a + b, lo = (a - b) * roots[offset + j * stride]. `offset` is an
    int, or an int64 tensor (batch,) of one offset a row (the tiles of
    `fr_das_block_plain`). Returns a new tensor."""
    a, b = _halves(x, log_half)
    tw = _twiddles(roots, log_half, stride, offset)
    lo = limbs.mont_mul_plain(spec, limbs.sub(spec, a, b),
                              tw.expand(a.shape))
    return _merged(limbs.add(spec, a, b), lo, x.shape)


def fr_dif_stage(spec: FieldSpec, x, roots, log_half: int,
                 stride: int) -> torch.Tensor:
    """One DIF stage of canonical Fr words, in place on x (batch, n, 8),
    which is returned (replaces
    kzg_tpu/field/pallas_kernels.py::_butterfly_lazy_dif_fn): the DAS
    extension's down-sweep butterfly hi = a + b, lo = (a - b) * tw."""
    if x.device.type == "cpu":
        x.copy_(fr_dif_stage_plain(spec, x, roots, log_half, stride))
        return x
    log_n = _check_stage("fr_dif_stage", x, roots, log_half,
                         ((1 << log_half) - 1) * stride)
    total = x.shape[0] * x.shape[1] // 2
    if total:
        lib = build.library("fr_kernels")
        LAUNCHES["fr_dif_stage"] += 1
        build.check(lib.kzg_fr_dif_stage(
            x.data_ptr(), roots.data_ptr(), log_n, log_half, stride, total,
            stream_of(x)), "fr_dif_stage")
    return x


def fr_signed_windows_plain(mont) -> torch.Tensor:
    canon = limbs.mont_mul_plain(FR, mont, FR.words([1], mont.device))
    canon = limbs.words_to_limbs(canon)                  # (..., 16)
    bias = torch.tensor(limbs.int_to_limbs(_SIGNED_WINDOW_BIAS, 16),
                        dtype=torch.int64, device=canon.device)
    biased, _ = limbs.normalize(canon + bias)
    shifts = torch.tensor([0, 4, 8, 12], dtype=torch.int64,
                          device=canon.device)
    wins = ((biased.unsqueeze(-1) >> shifts) & 0xF).flatten(-2)
    wins[..., :SIGNED_WINDOWS - 1] -= 8
    return wins.to(torch.int32)


def fr_signed_windows(mont) -> torch.Tensor:
    """Signed 4-bit windows of Fr words in Montgomery form (..., 8): int32
    (..., 64) LSB-first digits s with sum_j s_j 16^j == a (the canonical
    value), s_j in [-8, 7] for j < 63 and s_63 in [0, 8]. The kernel
    first reduces the words (REDC by 1); adding 0x0888...8 (63 eights)
    then shifts every low digit by +8 with the carries folded in, and
    a < 2^255 keeps the biased sum below 2^256. One launch (the recoding
    in front of the G1 scalar products; plain tensor code in
    kzg_tpu/field/fr.py:109-130)."""
    if mont.device.type == "cpu":
        return fr_signed_windows_plain(mont)
    mont = mont.contiguous()
    check_words(mont, FR_WORDS, "fr_signed_windows")
    if mont.data_ptr() % 16:
        raise ValueError("fr_signed_windows: words not 16-byte aligned")
    out = torch.empty(mont.shape[:-1] + (SIGNED_WINDOWS,),
                      dtype=torch.int32, device=mont.device)
    n = mont.numel() // FR_WORDS
    if n:
        lib = build.library("fr_kernels")
        LAUNCHES["fr_signed_windows"] += 1
        build.check(lib.kzg_fr_signed_windows(out.data_ptr(),
                                              mont.data_ptr(), n,
                                              stream_of(mont)),
                    "fr_signed_windows")
    return out


# ---- the routes of K1 and K2 (csrc/fr_route_kernels.cu) ----
ADD_SUB_OPS = {"add": 0, "sub": 1, "neg": 2}
# fr_batch_inv: threads a block, and lanes a block (chunk <= 32 a thread)
INV_THREADS = 256
INV_BLOCK_LANES = 8192
_INV_FULL, _INV_UP, _INV_DOWN = 0, 1, 2
# fr_fft_block: the widest tile, 2^11 values (64 KiB of shared memory)
FFT_TILE_LOG = 11
# fr_das_block: the sweeps of a pass (its tiles are fr_fft_block's)
DAS_DOWN, DAS_UP = 1, 2
# fr_zero_poly_leaves: factors a leaf (the reference uses <= 63,
# zero_poly.go:17) and coefficients a leaf (degree <= 64 fits, a power of
# two)
LEAF_FACTORS = 64
LEAF_WIDTH = 128


def _host_words(value: int, n_words: int):
    """A host buffer of `value`'s 32-bit words, LSB first, for a kernel
    argument passed by value."""
    return (ctypes.c_uint32 * n_words)(
        *((value >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)))


def fr_add_sub_plain(spec: FieldSpec, op: str, a, b=None) -> torch.Tensor:
    if op == "neg":
        return limbs.neg(spec, a)
    return {"add": limbs.add, "sub": limbs.sub}[op](spec, a, b)


def fr_add_sub(spec: FieldSpec, op: str, a, b=None) -> torch.Tensor:
    """a + b, a - b or -a ("add", "sub", "neg") for Fr or Fp words, in
    one launch (replaces plain tensor code, kzg_tpu/field/fr.py and fp.py
    add/sub/neg). a and b broadcast; on the card the broadcast is
    materialised unless b is one element (N,) or one element expanded."""
    if a.device.type == "cpu":
        return fr_add_sub_plain(spec, op, a, b)
    N = spec.n_words
    if op == "neg":
        aa, bb, bcast = a.contiguous(), None, False
    else:
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if b.dim() > 1 and not any(b.stride()[:-1]):
            b = b[(0,) * (b.dim() - 1)]      # one element, expanded
        bcast = b.dim() == 1 and a.shape == shape
        bb = b.contiguous() if bcast else b.expand(shape).contiguous()
        aa = a.expand(shape).contiguous()
        check_words(bb, N, "fr_add_sub")
        if bb.device != aa.device:
            raise ValueError("fr_add_sub: operands on different devices")
    check_words(aa, N, "fr_add_sub")
    out = torch.empty_like(aa)
    n = aa.numel() // N
    if n:
        lib = build.library("fr_route_kernels")
        LAUNCHES["fr_add_sub"] += 1
        build.check(lib.kzg_fr_add_sub(
            N, ADD_SUB_OPS[op], out.data_ptr(), aa.data_ptr(),
            (aa if bb is None else bb).data_ptr(), n, int(bcast),
            stream_of(aa)), "fr_add_sub")
    return out


def fr_pow_plain(spec: FieldSpec, a, e: int) -> torch.Tensor:
    """The ladder on the redundant engine's lazy products (each within
    the bounds the next one takes), made canonical once at the end."""
    if e == 0:
        return limbs.pow_static(spec, None, a, 0)
    c = limbs.consts(spec, a.device)
    acc = limbs.pow_static(spec, functools.partial(limbs.mul_lazy, c),
                           limbs.words_to_limbs(a), e)
    return limbs.limbs_to_words(limbs.canon(c, acc))


def fr_pow(spec: FieldSpec, a, e: int) -> torch.Tensor:
    """a^e for a static exponent 0 <= e < R, lane by lane, Fr or Fp: one
    thread a lane runs the ladder in registers, one launch (K1's route
    for the Fermat ladder, kzg_tpu/field/limbs.py:353-376). a^0 = 1."""
    if a.device.type == "cpu":
        return fr_pow_plain(spec, a, e)
    N = spec.n_words
    if not 0 <= e < spec.r:
        raise ValueError("fr_pow: exponent out of range")
    aa = a.contiguous()
    check_words(aa, N, "fr_pow")
    out = torch.empty_like(aa)
    n = aa.numel() // N
    if n:
        words = _host_words(e, N)
        lib = build.library("fr_route_kernels")
        LAUNCHES["fr_pow"] += 1
        build.check(lib.kzg_fr_pow(N, out.data_ptr(), aa.data_ptr(), n,
                                   ctypes.addressof(words), e.bit_length(),
                                   stream_of(aa)), "fr_pow")
    return out


def inv_chunking(n: int, threads: int = INV_THREADS,
                 block_lanes: int = INV_BLOCK_LANES):
    """(lanes a thread, blocks) of fr_batch_inv over n lanes: one block
    up to `block_lanes`, the chunk sized so that it is filled."""
    chunk = -(-min(n, block_lanes) // threads)
    return chunk, -(-n // (chunk * threads))


def fr_batch_inv_plain(spec: FieldSpec, a, threads: int = INV_THREADS,
                       block_lanes: int = INV_BLOCK_LANES) -> torch.Tensor:
    """The kernel's Montgomery trick on the plain engine, chunk for chunk:
    running products in each thread's chunk (zero lanes as 1), prefix and
    suffix scans of the chunk products in each block, the inverse of each
    block's total (one ladder, or for several blocks the same batch
    inversion of the totals), then the back pass. Zero lanes map to 0."""
    n = a.numel() // spec.n_words
    dev = a.device
    one = spec.words([spec.one_mont], dev)[0]
    mul = functools.partial(limbs.mont_mul_plain, spec)
    chunk, n_blocks = inv_chunking(n, threads, block_lanes)
    if n_blocks > block_lanes:
        raise ValueError("fr_batch_inv: too many lanes")
    flat = a.reshape(n, spec.n_words)
    zero = limbs.is_zero(flat)
    x = limbs.select(zero, one, flat)
    x = torch.cat((x, one.expand(n_blocks * threads * chunk - n, -1)))
    x = x.reshape(n_blocks, threads, chunk, spec.n_words)
    run = [x[:, :, 0]]
    for k in range(1, chunk):
        run.append(mul(run[-1], x[:, :, k]))
    cprod = run[-1].transpose(0, 1)                  # (threads, blocks, N)
    pre = limbs.prefix_products(mul, cprod)
    suf = limbs.prefix_products(mul, cprod, reverse=True)
    if n_blocks == 1:
        total_inv = fr_pow_plain(spec, pre[-1], spec.modulus - 2)
    else:
        total_inv = fr_batch_inv_plain(spec, pre[-1], threads, block_lanes)
    ones = one.expand(1, n_blocks, -1)
    c = mul(mul(total_inv, torch.cat((ones, pre[:-1]))),
            torch.cat((suf[1:], ones))).transpose(0, 1)
    inv = [None] * chunk
    for k in range(chunk - 1, -1, -1):
        inv[k] = mul(c, run[k - 1] if k else one)
        c = mul(c, x[:, :, k])
    out = torch.stack(inv, dim=2).reshape(-1, spec.n_words)[:n]
    return limbs.select(zero, torch.zeros_like(out), out).reshape(a.shape)


def fr_batch_inv(spec: FieldSpec, a) -> torch.Tensor:
    """Inverse of every Fr lane over all leading axes, zero lanes -> 0
    (they do not poison the batch): the Montgomery trick in one launch up
    to INV_BLOCK_LANES lanes and three above (K1's route for
    kzg_tpu/field/limbs.py:389-422: its scans and its Fermat ladder)."""
    if a.device.type == "cpu":
        return fr_batch_inv_plain(spec, a)
    if spec.n_words != FR_WORDS:
        raise ValueError("fr_batch_inv: Fr words only")
    n = a.numel() // FR_WORDS
    flat = a.reshape(n, FR_WORDS).contiguous()
    check_words(flat, FR_WORDS, "fr_batch_inv")
    out = torch.empty_like(flat)
    if not n:
        return out.reshape(a.shape)
    chunk, n_blocks = inv_chunking(n)
    if n_blocks > INV_BLOCK_LANES:
        raise ValueError("fr_batch_inv: too many lanes")
    e = spec.modulus - 2
    e_words = _host_words(e, FR_WORDS)
    words = ctypes.addressof(e_words)
    lib = build.library("fr_route_kernels")
    stream = stream_of(flat)

    def launch(dst, src, lanes, ch, blocks, totals, phase):
        LAUNCHES["fr_batch_inv"] += 1
        build.check(lib.kzg_fr_batch_inv(
            dst.data_ptr(), src.data_ptr(), lanes, ch, blocks,
            None if totals is None else totals.data_ptr(), phase, words,
            e.bit_length(), stream), "fr_batch_inv")

    if n_blocks == 1:
        launch(out, flat, n, chunk, 1, None, _INV_FULL)
    else:
        totals = torch.empty((n_blocks, FR_WORDS), dtype=torch.int32,
                             device=flat.device)
        totals_inv = torch.empty_like(totals)
        launch(out, flat, n, chunk, n_blocks, totals, _INV_UP)
        launch(totals_inv, totals, n_blocks, inv_chunking(n_blocks)[0], 1,
               None, _INV_FULL)
        launch(out, flat, n, chunk, n_blocks, totals_inv, _INV_DOWN)
    return out.reshape(a.shape)


def fft_plan(log_n: int, max_tile_log: int = FFT_TILE_LOG) -> tuple:
    """Stages a pass of fr_fft_block: log_n split into the fewest passes
    of at most max_tile_log stages, as evenly as possible (13 -> 7, 6;
    20 -> 10, 10). A width-1 transform is one pass of no stage."""
    if log_n == 0:
        return (0,)
    passes = -(-log_n // max_tile_log)
    q, rem = divmod(log_n, passes)
    return tuple(q + (i < rem) for i in range(passes))


def _tiles(x, lo: int, kk: int):
    """(batch, n, N) -> (batch * tiles, 2^kk, N): tile (hi, o) holds the
    positions hi 2^(lo+kk) + i 2^lo + o, i < 2^kk."""
    batch, n, N = x.shape
    t = x.reshape(batch, n >> (lo + kk), 1 << kk, 1 << lo, N)
    return t.transpose(2, 3).reshape(-1, 1 << kk, N)


def _untiles(t, shape, lo: int, kk: int):
    batch, n, N = shape
    t = t.reshape(batch, n >> (lo + kk), 1 << lo, 1 << kk, N)
    return t.transpose(2, 3).reshape(shape)


def fr_fft_block_plain(spec: FieldSpec, x, roots, max_width: int,
                       scale=None, max_tile_log: int = FFT_TILE_LOG):
    """The kernel's passes on the plain engine: the bit-reversal, then for
    each pass of `fft_plan` the tiles gathered by the kernel's index
    formula and each of its stages as `fr_butterfly_stage_plain` with one
    twiddle offset a tile, then the scale. Returns a new tensor."""
    from ..ntt.bitrev import brp_permute  # ntt's package imports this one

    shape = x.shape
    log_n = shape[1].bit_length() - 1
    y = brp_permute(x, axis=1)
    lo = 0
    for kk in fft_plan(log_n, max_tile_log):
        t = _tiles(y, lo, kk)
        o = torch.arange(t.shape[0], device=x.device) % (1 << lo)
        for st in range(kk):
            tw = max_width >> (lo + 1 + st)
            t = fr_butterfly_stage_plain(spec, t, roots, st, tw << lo,
                                         o * tw if lo else 0)
        y = _untiles(t, shape, lo, kk)
        lo += kk
    if scale is not None:
        y = fr_scale_plain(spec, y, spec.words([spec.to_mont_int(scale)],
                                               x.device)[0])
    return y


def fr_fft_block(spec: FieldSpec, x, roots, max_width: int, scale=None,
                 max_tile_log: int = FFT_TILE_LOG) -> torch.Tensor:
    """The radix-2 DIT transform of x (batch, n, 8) in natural order, Fr:
    out[i] = sum_j x[j] w^(i j) with stage s's twiddles
    roots[j (max_width >> s)], times the integer `scale` if given. One
    launch a pass of `fft_plan` (at most 2 up to 2^22 points): the first
    reads x in bit-reversed order, the last scales in its store (K2's
    route, kzg_tpu/field/pallas_kernels.py::_butterfly_lazy_fn one launch
    a stage). Returns a new tensor."""
    if x.device.type == "cpu":
        return fr_fft_block_plain(spec, x, roots, max_width, scale,
                                  max_tile_log)
    x = x.contiguous()
    check_words(x, FR_WORDS, "fr_fft_block")
    check_words(roots, FR_WORDS, "fr_fft_block")
    if x.dim() != 3 or roots.device != x.device:
        raise ValueError("fr_fft_block: x must be (batch, n, 8) and roots "
                         "on its device")
    batch, n, _ = x.shape
    log_n = n.bit_length() - 1
    log_max = max_width.bit_length() - 1
    if (n != 1 << log_n or max_width != 1 << log_max or n > max_width
            or roots.shape[0] < max_width // 2
            or not 0 < max_tile_log <= FFT_TILE_LOG):
        raise ValueError("fr_fft_block: bad width, domain or tile")
    out = torch.empty_like(x)
    if not batch:
        return out
    lib = build.library("fr_route_kernels")
    words = None if scale is None else _host_words(
        spec.to_mont_int(scale), FR_WORDS)
    plan = fft_plan(log_n, max_tile_log)
    src, lo = x, 0
    for p, kk in enumerate(plan):
        last = p == len(plan) - 1
        LAUNCHES["fr_fft_block"] += 1
        build.check(lib.kzg_fr_fft_block(
            src.data_ptr(), out.data_ptr(), roots.data_ptr(), log_n, lo, kk,
            log_max, int(p == 0), batch,
            ctypes.addressof(words) if last and words is not None else None,
            stream_of(x)), "fr_fft_block")
        src, lo = out, lo + kk
    return out


def das_plan(log_n: int, max_tile_log: int = FFT_TILE_LOG) -> tuple:
    """Passes (lo, kk, sweeps) of fr_das_block over the K = log_n levels:
    `fft_plan`'s split, the smallest part the bottom tile (lo = 0), which
    runs its levels down and straight back up (DAS_DOWN | DAS_UP); the
    other parts run their down levels before it, top first, and their up
    levels after it. One pass up to max_tile_log levels, three up to
    twice that."""
    if not 0 < max_tile_log <= FFT_TILE_LOG:
        raise ValueError("fr_das_block: bad tile")
    sizes = fft_plan(log_n, max_tile_log)[::-1]
    top = [(sum(sizes[:i]), kk) for i, kk in enumerate(sizes)][1:]
    return (tuple((lo, kk, DAS_DOWN) for lo, kk in reversed(top))
            + ((0, sizes[0], DAS_DOWN | DAS_UP),)
            + tuple((lo, kk, DAS_UP) for lo, kk in top))


def _das_check(x, max_width: int) -> int:
    """Validate the extension's operand (..., n, 8); -> log2 n."""
    if x.dim() < 2 or x.shape[-1] != FR_WORDS:
        raise ValueError("fr_das_block: x must be (..., n, 8)")
    n = x.shape[-2]
    log_n = n.bit_length() - 1
    if (n < 1 or n != 1 << log_n or max_width & (max_width - 1)
            or 2 * n > max_width):
        raise ValueError("fr_das_block: need a power-of-two count of values "
                         "and a domain at least twice as wide")
    return log_n


def fr_das_block_plain(spec: FieldSpec, x, rev_roots, roots, max_width: int,
                       interleave: bool = False,
                       max_tile_log: int = FFT_TILE_LOG):
    """The kernel's passes on the plain engine: for each pass of
    `das_plan` the tiles gathered by the kernel's index formula, its down
    levels as `fr_dif_stage_plain` and its up levels as
    `fr_butterfly_stage_plain`, each with one twiddle offset a tile, then
    the scale by 1/n and the interleave. Returns a new tensor."""
    log_n = _das_check(x, max_width)
    log_max = max_width.bit_length() - 1
    lead, n = x.shape[:-2], x.shape[-2]
    x = x.reshape(-1, n, FR_WORDS)
    shape = x.shape
    y = x
    for lo, kk, sweeps in das_plan(log_n, max_tile_log):
        t = _tiles(y, lo, kk)
        o = torch.arange(t.shape[0], device=x.device) % (1 << lo)
        if sweeps & DAS_DOWN:
            for st in range(kk - 1, -1, -1):
                s = 1 << (log_max - 1 - lo - st)
                t = fr_dif_stage_plain(spec, t, rev_roots, st, s << lo, o * s)
        if sweeps & DAS_UP:
            for st in range(kk):
                s = 1 << (log_max - 2 - lo - st)
                t = fr_butterfly_stage_plain(spec, t, roots, st,
                                             (2 * s) << lo, s + o * (2 * s))
        y = _untiles(t, shape, lo, kk)
    c = spec.words([spec.to_mont_int(pow(n, -1, spec.modulus))],
                   x.device)[0]
    y = fr_scale_plain(spec, y, c)
    if interleave:
        y = torch.stack((x, y), dim=2)
    return y.reshape(lead + ((2 if interleave else 1) * n, FR_WORDS))


def fr_das_block(spec: FieldSpec, x, rev_roots, roots, max_width: int,
                 interleave: bool = False,
                 max_tile_log: int = FFT_TILE_LOG) -> torch.Tensor:
    """The DAS extension of x (..., n, 8), Fr values at the even points
    w^(2i) of the max_width domain: their polynomial's values at the odd
    points, (..., n, 8), or with `interleave` the extended vectors
    (..., 2n, 8) [e0, o0, e1, o1, ...]. rev_roots and roots are the
    domain's inverse and forward roots tables. One launch a pass of
    `das_plan`: the K DIF levels, the K DIT levels and the scale by 1/n
    (replaces kzg_tpu/field/pallas_kernels.py::_butterfly_lazy_dif_fn,
    ::_butterfly_lazy_fn and ::_canon_scale_fn, one launch a level, in
    kzg_tpu/ntt/das.py::_das_core_pallas). Returns a new tensor."""
    log_n = _das_check(x, max_width)
    plan = das_plan(log_n, max_tile_log)
    if x.device.type == "cpu":
        return fr_das_block_plain(spec, x, rev_roots, roots, max_width,
                                  interleave, max_tile_log)
    lead, n = x.shape[:-2], x.shape[-2]
    x = x.reshape(-1, n, FR_WORDS).contiguous()
    for t in (x, rev_roots, roots):
        check_words(t, FR_WORDS, "fr_das_block")
        if t.device != x.device:
            raise ValueError("fr_das_block: operands on different devices")
    if min(rev_roots.shape[0], roots.shape[0]) < max_width // 2:
        raise ValueError("fr_das_block: roots tables too short")
    batch = x.shape[0]
    odds = torch.empty_like(x)
    out = (torch.empty((batch, 2 * n, FR_WORDS), dtype=x.dtype,
                       device=x.device) if interleave else odds)
    out_shape = lead + out.shape[-2:]
    if not batch:
        return out.reshape(out_shape)
    lib = build.library("fr_route_kernels")
    words = _host_words(spec.to_mont_int(pow(n, -1, spec.modulus)), FR_WORDS)
    stream = stream_of(x)
    src = x
    for p, (lo, kk, sweeps) in enumerate(plan):
        last = p == len(plan) - 1
        LAUNCHES["fr_das_block"] += 1
        build.check(lib.kzg_fr_das_block(
            src.data_ptr(), (out if last else odds).data_ptr(),
            x.data_ptr() if last and interleave else None,
            rev_roots.data_ptr(), roots.data_ptr(), log_n, lo, kk,
            max_width.bit_length() - 1, sweeps, batch,
            ctypes.addressof(words) if last else None, stream),
            "fr_das_block")
        src = odds
    return out.reshape(out_shape)


def fr_zero_poly_leaves_plain(spec: FieldSpec, roots, root_idx, valid):
    """(G, S) host root indices and validity -> (G, LEAF_WIDTH, 8) monic
    leaves prod(x - roots[idx]) over each leaf's valid factors; one step
    a factor position, batched over all leaves (each step one
    shift-multiply-add, selected where the factor is valid)."""
    G, S = root_idx.shape
    dev = roots.device
    idx = torch.as_tensor(root_idx.reshape(-1), dtype=torch.long, device=dev)
    neg_roots = limbs.neg(spec, roots[idx]).reshape(G, S, spec.n_words)
    poly = torch.zeros((G, LEAF_WIDTH, spec.n_words), dtype=torch.int32,
                       device=dev)
    poly[:, 0] = spec.words([spec.one_mont], dev)[0]
    for s in range(S):
        if not valid[:, s].any():
            continue
        shifted = torch.cat((torch.zeros_like(poly[:, :1]), poly[:, :-1]),
                            dim=1)
        cand = limbs.add(spec, shifted, limbs.mont_mul_plain(
            spec, poly, neg_roots[:, s, None, :]))
        if valid[:, s].all():
            poly = cand
        else:
            poly = limbs.select(torch.as_tensor(valid[:, s, None],
                                                device=dev), cand, poly)
    return poly


def fr_zero_poly_leaves(spec: FieldSpec, roots, root_idx: np.ndarray,
                        valid: np.ndarray) -> torch.Tensor:
    """The zero polynomial's leaves, (G, LEAF_WIDTH, 8): leaf g is
    prod(x - roots[root_idx[g, s]]) over the s where valid[g, s] (1 with
    none), the gather and negation included, one launch (plain tensor
    code in kzg_tpu/das/zero_poly.py:34-51). root_idx and valid are host
    (G, LEAF_FACTORS) arrays."""
    if roots.device.type == "cpu":
        return fr_zero_poly_leaves_plain(spec, roots, root_idx, valid)
    check_words(roots, FR_WORDS, "fr_zero_poly_leaves")
    G, S = root_idx.shape
    if S != LEAF_FACTORS or valid.shape != root_idx.shape:
        raise ValueError(f"fr_zero_poly_leaves: need (G, {LEAF_FACTORS}) "
                         "indices and validity")
    # one int32 a factor: its root's index, or -1 for none
    factors = np.where(valid, root_idx, -1).astype(np.int32)
    if factors.size and not (factors < roots.shape[0]).all():
        raise ValueError("fr_zero_poly_leaves: root index out of range")
    out = torch.empty((G, LEAF_WIDTH, FR_WORDS), dtype=torch.int32,
                      device=roots.device)
    if G:
        f = torch.from_numpy(factors).to(roots.device)
        lib = build.library("fr_route_kernels")
        LAUNCHES["fr_zero_poly_leaves"] += 1
        build.check(lib.kzg_fr_zero_poly_leaves(
            out.data_ptr(), roots.data_ptr(), f.data_ptr(), G,
            stream_of(roots)), "fr_zero_poly_leaves")
    return out
