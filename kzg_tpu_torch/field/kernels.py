"""Field kernels K1 (`mont_mul`, and its `fr_scale` exit form), K2
(`fr_butterfly_stage`), `fr_dif_stage`, `butterfly` and the digit
recoding `fr_signed_windows`, with their plain PyTorch versions.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (csrc/fr_kernels.cu) or raises. Each
launch adds one to the wrapper's entry in `LAUNCHES`.
"""

from __future__ import annotations

import torch

from .. import build
from . import limbs
from .limbs import FieldSpec

LAUNCHES = {"mont_mul": 0, "fr_scale": 0, "fr_butterfly_stage": 0,
            "fr_dif_stage": 0, "butterfly": 0, "fr_signed_windows": 0}

FR_WORDS = 8
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
    element (N,)."""
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


def fr_butterfly_stage_plain(spec: FieldSpec, x, roots, log_half: int,
                             stride: int, offset: int = 0) -> torch.Tensor:
    """One DIT stage over x (batch, n, 8): within each group of
    m = 2^(log_half+1), position j pairs with j + m/2 and twiddle
    roots[offset + j * stride]; hi = a + b*tw, lo = a - b*tw. Returns a
    new tensor."""
    a, b = _halves(x, log_half)
    if log_half > 0 or offset:
        half = 1 << log_half
        tw = roots[offset: offset + half * stride: stride]
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
                       stride: int) -> torch.Tensor:
    """One DIF stage over x (batch, n, 8): within each group of
    m = 2^(log_half+1), position j pairs with j + m/2;
    hi = a + b, lo = (a - b) * roots[j * stride]. Returns a new tensor."""
    a, b = _halves(x, log_half)
    tw = roots[: (1 << log_half) * stride: stride]
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


def fr_signed_windows_plain(canon) -> torch.Tensor:
    canon = limbs.words_to_limbs(canon)                  # (..., 16)
    bias = torch.tensor(limbs.int_to_limbs(_SIGNED_WINDOW_BIAS, 16),
                        dtype=torch.int64, device=canon.device)
    biased, _ = limbs.normalize(canon + bias)
    shifts = torch.tensor([0, 4, 8, 12], dtype=torch.int64,
                          device=canon.device)
    wins = ((biased.unsqueeze(-1) >> shifts) & 0xF).flatten(-2)
    wins[..., :SIGNED_WINDOWS - 1] -= 8
    return wins.to(torch.int32)


def fr_signed_windows(canon) -> torch.Tensor:
    """Signed 4-bit windows of canonical Fr words (..., 8): int32
    (..., 64) LSB-first digits s with sum_j s_j 16^j == a, s_j in [-8, 7]
    for j < 63 and s_63 in [0, 8]. Adding 0x0888...8 (63 eights) shifts
    every low digit by +8 with the carries folded in; a < 2^255 keeps the
    biased sum below 2^256. One launch (the recoding in front of the G1
    scalar products; plain tensor code in kzg_tpu/field/fr.py:109-130)."""
    if canon.device.type == "cpu":
        return fr_signed_windows_plain(canon)
    canon = canon.contiguous()
    check_words(canon, FR_WORDS, "fr_signed_windows")
    out = torch.empty(canon.shape[:-1] + (SIGNED_WINDOWS,),
                      dtype=torch.int32, device=canon.device)
    n = canon.numel() // FR_WORDS
    if n:
        lib = build.library("fr_kernels")
        LAUNCHES["fr_signed_windows"] += 1
        build.check(lib.kzg_fr_signed_windows(out.data_ptr(),
                                              canon.data_ptr(), n,
                                              stream_of(canon)),
                    "fr_signed_windows")
    return out
