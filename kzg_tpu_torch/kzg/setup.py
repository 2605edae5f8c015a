"""Insecure testing setups: powers of a known secret times the G1
generator (reference: GenerateTestingSetup, setup.go:9-26). For tests and
benchmarks only. No G2 part: this slice only generates proofs.
"""

from __future__ import annotations

from ..curve import g1
from ..field import fr
from ..field.constants import FR_MODULUS
from ..ntt.domain import FFTSettings
from ..utils import host_ec
from .settings import KZGSettings


def secret_powers(secret: int, n: int) -> list:
    secret %= FR_MODULUS
    out, p = [], 1
    for _ in range(n):
        out.append(p)
        p = p * secret % FR_MODULUS
    return out


def generate_testing_setup(secret: int, n: int, device="cuda"):
    """-> (G1 JacobianPoint batch (n,), host affine list): [s^i] G1 by
    exact host arithmetic (small n only)."""
    g = host_ec.g1_generator()
    s1 = [host_ec.g1_mul(g, k) for k in secret_powers(secret, n)]
    return g1.from_affine_ints(s1, device), s1


def insecure_kzg_settings_device(secret: int, n: int,
                                 fs: FFTSettings) -> KZGSettings:
    """KZGSettings whose n-point G1 CRS is one batched scalar multiply
    (one K3 launch) on fs.device (kzg_tpu/kzg/setup.py:109-136)."""
    powers = fr.from_int(secret_powers(secret, n), fs.device)
    return KZGSettings(fs, g1.mul(g1.generator((n,), fs.device), powers))
