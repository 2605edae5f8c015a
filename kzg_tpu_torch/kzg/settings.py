"""KZG settings: the FFT domain and the G1 CRS [s^i]_1.

A minimal counterpart of kzg_tpu/kzg/settings.py for proof generation;
commit, prove and verify come with a later slice.
"""

from __future__ import annotations

from ..curve.weierstrass import JacobianPoint
from ..ntt.domain import FFTSettings


class KZGSettings:
    def __init__(self, fs: FFTSettings, secret_g1: JacobianPoint):
        self.fs = fs
        self.secret_g1 = secret_g1
