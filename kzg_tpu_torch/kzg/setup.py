"""Insecure testing setups: powers of a known secret times the G1 and G2
generators (reference: GenerateTestingSetup, setup.go:9-26;
kzg_tpu/kzg/setup.py). For tests and benchmarks only.
"""

from __future__ import annotations

import functools

from ..curve import g1, g2
from ..field import fr
from ..field.constants import FR_MODULUS
from ..ntt.domain import FFTSettings
from ..utils import host_ec
from .settings import KZGSettings


def secret_from_string(hex_seed: str) -> int:
    """A hex secret like the reference tests' "1927409816240961209460912649124"
    (setup.go tests), reduced mod r (kzg_tpu/kzg/setup.py:33-36)."""
    return int(hex_seed, 16) % FR_MODULUS


def secret_powers(secret: int, n: int) -> list:
    secret %= FR_MODULUS
    out, p = [], 1
    for _ in range(n):
        out.append(p)
        p = p * secret % FR_MODULUS
    return out


@functools.lru_cache(maxsize=None)
def generate_testing_setup_ints(secret: int, n: int):
    """-> (s1, s2): [s^i] G1 as affine int pairs and [s^i] G2 as affine
    Fp2 pairs, i < n, by exact host arithmetic (small n only)."""
    powers = secret_powers(secret, n)
    s1 = tuple(host_ec.g1_mul(host_ec.g1_generator(), k) for k in powers)
    s2 = tuple(host_ec.g2_mul(host_ec.g2_generator(), k) for k in powers)
    return s1, s2


def generate_testing_setup(secret: int, n: int, device="cuda"):
    """-> (G1 JacobianPoint batch (n,), G2 batch (n,), host affine G1 list,
    host affine G2 list) (kzg_tpu/kzg/setup.py:139-156)."""
    s1, s2 = generate_testing_setup_ints(secret, n)
    return (g1.from_affine_ints(s1, device), g2.from_affine_ints(s2, device),
            list(s1), list(s2))


def insecure_kzg_settings_device(secret: int, n: int, fs: FFTSettings,
                                 g2_indices=(1,)) -> KZGSettings:
    """KZGSettings whose n-point G1 CRS is one batched scalar multiply
    (one K3 launch) on fs.device, and whose [s^i]_2 are computed on the
    host only for the indices the pairing checks read: 1 for
    check_proof_single, the coset width for check_proof_multi (the rest
    None) (kzg_tpu/kzg/setup.py:109-136)."""
    powers = fr.from_int(secret_powers(secret, n), fs.device)
    s2 = [None] * n
    for i in set(int(i) for i in g2_indices):
        if 0 <= i < n:
            s2[i] = host_ec.g2_mul(host_ec.g2_generator(),
                                   pow(secret, i, FR_MODULUS))
    return KZGSettings(fs, g1.mul(g1.generator((n,), fs.device), powers), s2)


def bench_kzg_settings(n: int, secret: int = 1927409816240961209460912649124,
                       device="cuda") -> KZGSettings:
    """A prover's KZGSettings with an n-point G1 CRS from one K3 launch on
    a domain of 2^ceil(log2(2n - 1)) and no [s^i]_2: commitments, proofs
    and FK20 only (kzg_tpu/kzg/setup.py:76-101)."""
    fs = FFTSettings((2 * n - 1).bit_length(), device)
    powers = fr.from_int(secret_powers(secret, n), fs.device)
    return KZGSettings(fs, g1.mul(g1.generator((n,), fs.device), powers))
