"""EIP-4844 settings: the trusted setup and the bit-reversed domain
(kzg_tpu/eth/settings.py; reference: eth/globals.go:39-72).

An `EthSettings` holds the Lagrange CRS in bit-reversed order as a G1
batch on the device, with its 64-window fixed-base tables built at the
first commitment (`lagrange_tables`); the domain as host ints (for the
transcripts and exact checks) and as device words (for the barycentric
evaluation); and [s]_2 for the host pairing check. It loads a ceremony
file (`from_json`, the reference's trusted_setup.json schema) or is made
insecurely from a known secret for tests (`insecure`).
"""

from __future__ import annotations

import functools
import json

import torch

from ..curve import g1, serialization
from ..curve.msm import fixed_base_tables, lin_comb_fixed
from ..curve.weierstrass import JacobianPoint
from ..field import fp, fr
from ..field.constants import FR_MODULUS, fr_scale2_root_of_unity
from ..ntt.bitrev import bit_reversal_indices
from ..utils import host_ec

FIELD_ELEMENTS_PER_BLOB = 4096


class EthSettings:
    """Everything the EIP-4844 functions need.

    width: field elements a blob (4096 in production; tests shrink it)
    domain_ints: host list, w^rev(i) for i < width; domain_set: as a set
    domain: (width, 8) Fr words of the same, on `device`
    width_inv: (8,) Fr words of 1/width
    lagrange_affine_brp: host affine Lagrange CRS in bit-reversed order
    lagrange_brp: the same as a (width,) G1 batch on `device`
    setup_g2_1: host affine [s]_2
    setup_g1_affine: the host monomial CRS, or None
    """

    def __init__(self, width: int, lagrange_affine, setup_g2_1,
                 setup_g1_affine=None, device="cuda"):
        if width & (width - 1) != 0:
            raise ValueError("width must be a power of two")
        self.width = width
        self.device = torch.device(device)
        root = fr_scale2_root_of_unity(width.bit_length() - 1)
        rev = bit_reversal_indices(width)
        self.domain_ints = [pow(root, int(i), FR_MODULUS) for i in rev]
        self.domain_set = set(self.domain_ints)
        self.domain = fr.from_int(self.domain_ints, self.device)
        self.width_inv = fr.from_int(pow(width, -1, FR_MODULUS), self.device)
        self.lagrange_affine_brp = [lagrange_affine[int(i)] for i in rev]
        self.lagrange_brp = g1.from_affine_ints(self.lagrange_affine_brp,
                                                self.device)
        self.setup_g2_1 = setup_g2_1
        self.setup_g1_affine = setup_g1_affine

    @functools.cached_property
    def lagrange_tables(self) -> torch.Tensor:
        """Fixed-base tables of `lagrange_brp`, (width, 64, 8, 36) int32
        (curve/msm.py): built at the first commitment and kept,
        301,989,888 bytes at 4096 points."""
        return fixed_base_tables(self.lagrange_brp)

    def commit(self, polys) -> JacobianPoint:
        """[p(s)]_1 of polynomials in evaluation form, (..., width, 8) ->
        (...,) points: one fixed-base product on the Lagrange tables and
        one g1_sum (reference: eth/settings.py:72-85's MSM)."""
        return lin_comb_fixed(self.lagrange_tables, polys)

    @classmethod
    def from_json(cls, path: str, device="cuda") -> "EthSettings":
        """A ceremony file of the reference's schema (eth/globals.go:33-37):
        {"setup_G1": [hex48...], "setup_G2": [hex96...],
        "setup_G1_lagrange": [hex48...]}, compressed points. The G1 points
        are decompressed on the card (decompress_g1_batch: the square
        roots on fr_pow, the subgroup check on K3)."""
        with open(path) as f:
            data = json.load(f)
        lagrange = serialization.decompress_g1_batch(
            [bytes.fromhex(h) for h in data["setup_G1_lagrange"]],
            device=device)
        g2_1 = serialization.g2_from_hex(data["setup_G2"][1])
        setup_g1 = (serialization.decompress_g1_batch(
            [bytes.fromhex(h) for h in data["setup_G1"]], device=device)
            if "setup_G1" in data else None)
        return cls(len(lagrange), lagrange, g2_1, setup_g1, device)

    @classmethod
    def insecure(cls, secret: int, width: int,
                 device="cuda") -> "EthSettings":
        """A testing setup from a known secret (the eth layer's
        GenerateTestingSetup, setup.go:9-26): the Lagrange scalars
            L_i(s) = w^i (s^width - 1) / (width (s - w^i))
        and the powers s^i on the host, then all 2 width points
        [L_i(s)]G and [s^i]G in one K3 launch, and one batched
        conversion to affine. Nothing is cached on disk."""
        root = fr_scale2_root_of_unity(width.bit_length() - 1)
        sw = pow(secret, width, FR_MODULUS)
        num = (sw - 1) * pow(width, -1, FR_MODULUS) % FR_MODULUS
        lag_sc, pow_sc = [], []
        power, wi = 1, 1
        for _ in range(width):
            lag_sc.append(wi * num * pow(secret - wi, -1, FR_MODULUS)
                          % FR_MODULUS)
            pow_sc.append(power)
            power = power * secret % FR_MODULUS
            wi = wi * root % FR_MODULUS
        pts = g1.mul(g1.generator((2 * width,), device),
                     fr.from_int(lag_sc + pow_sc, device))
        ax, ay, _ = g1.to_affine(pts)
        xs, ys = fp.to_int_batch(ax), fp.to_int_batch(ay)
        lagrange = list(zip(xs[:width], ys[:width]))
        s1 = list(zip(xs[width:], ys[width:]))
        g2_1 = host_ec.g2_mul(host_ec.g2_generator(), secret % FR_MODULUS)
        return cls(width, lagrange, g2_1, s1, device)
