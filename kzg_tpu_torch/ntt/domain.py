"""FFT domain settings: the roots-of-unity tables as device tensors
(reference: FFTSettings, fft.go:34-61)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fr
from ..field.constants import FR_MODULUS, fr_scale2_root_of_unity


def next_pow_of_2(v: int) -> int:
    """reference: fft.go:11-16."""
    if v == 0:
        return 1
    return 1 << (v - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _expanded_roots_int(max_scale: int) -> tuple:
    """Power circle of the 2^max_scale root: [1, w, ..., w^(n-1), 1]
    (reference: expandRootOfUnity, fft.go:21-32). Host ints, cached."""
    w = fr_scale2_root_of_unity(max_scale)
    out = [1]
    cur = w
    while cur != 1:
        out.append(cur)
        cur = cur * w % FR_MODULUS
    out.append(1)
    assert len(out) == (1 << max_scale) + 1
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _roots_mont_np(max_scale: int) -> np.ndarray:
    r = fr.SPEC.r
    buf = b"".join((v * r % FR_MODULUS).to_bytes(32, "little")
                   for v in _expanded_roots_int(max_scale))
    return np.frombuffer(buf, dtype="<i4").reshape(-1, fr.N_WORDS)


class FFTSettings:
    """Precomputed 2^max_scale evaluation domain on `device`.

    expanded_roots_of_unity: int32 (width+1, 8), w^0..w^width (both ends 1)
    reverse_roots_of_unity:  int32 (width+1, 8), the inverses w^-j
    """

    def __init__(self, max_scale: int, device="cuda"):
        if not 0 <= max_scale <= 31:
            raise ValueError("max scale out of range")
        self.max_scale = max_scale
        self.max_width = 1 << max_scale
        self.device = torch.device(device)
        self.root_of_unity_int = fr_scale2_root_of_unity(max_scale)
        roots = _roots_mont_np(max_scale)
        self.expanded_roots_of_unity = torch.from_numpy(
            roots.copy()).to(self.device)
        self.reverse_roots_of_unity = torch.from_numpy(
            roots[::-1].copy()).to(self.device)
        self._inv_len = {}

    def roots_of_unity_int(self) -> tuple:
        """The expanded circle as Python ints (host use)."""
        return _expanded_roots_int(self.max_scale)

    def inv_length(self, n: int) -> torch.Tensor:
        """n^-1 mod r as Montgomery words (8,) on the domain's device,
        kept per n."""
        if n not in self._inv_len:
            self._inv_len[n] = fr.from_int(pow(n, -1, FR_MODULUS),
                                           self.device)
        return self._inv_len[n]
