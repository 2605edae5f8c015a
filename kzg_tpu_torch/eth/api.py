"""EIP-4844 functions: blob commitments, proofs, the precompile
(kzg_tpu/eth/api.py; reference: eth/eth.go, eth/helpers.go).

The sha256 transcripts, byte parsing and pairing checks stay on the host
(the pairing on the native library, curve/pairing.py). The work per field
element runs on the card: blob parsing (one K1 launch for all blobs),
the commitments and the quotient's commitment as fixed-base MSMs on the
Lagrange tables (fr_signed_windows, g1_fixed_base_mul, g1_sum), the
barycentric evaluation and the quotient (fr_add_sub, mont_mul,
fr_batch_inv, fr_pow), and the aggregated commitment over the decompressed
commitments as a variable-base MSM (lin_comb_g1: g1_add, g1_sum,
g1_horner).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from .. import poly as polyops
from ..curve import g1, pairing, serialization
from ..curve.msm import lin_comb_g1
from ..field import fr
from ..field.constants import FR_MODULUS
from ..utils import host_ec
from .settings import EthSettings

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
BLOB_COMMITMENT_VERSION_KZG = 0x01
BLOB_TX_TYPE = 5
PRECOMPILE_INPUT_LENGTH = 192
BLOB_VERSIONED_HASHES_OFFSET = 258


@dataclass
class BlobsSidecar:
    """reference: BlobsSidecar (eth/eth.go:33-38)."""

    beacon_block_root: bytes
    beacon_block_slot: int
    blobs: Sequence[bytes]
    kzg_aggregated_proof: bytes


# ---------------- field and byte helpers ----------------
def bytes_to_bls_field(b32: bytes) -> Optional[int]:
    """32 little-endian bytes -> int < r, or None (reference:
    eth/helpers.go:107-110)."""
    v = int.from_bytes(b32, "little")
    return v if v < FR_MODULUS else None


def hash_to_bls_field(data: bytes) -> int:
    """sha256 digest as a little-endian int mod r (reference:
    hashToBLSField, eth/helpers.go:113-133)."""
    h = hashlib.sha256(data).digest()
    return int.from_bytes(h, "little") % FR_MODULUS


def compute_powers(r: int, n: int) -> List[int]:
    """[1, r, r^2, ...] (reference: ComputePowers, eth/helpers.go:87-95)."""
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * r % FR_MODULUS
    return out


def kzg_to_versioned_hash(commitment: bytes) -> bytes:
    """sha256 with the version byte (reference: KZGToVersionedHash,
    eth/eth.go:137-141)."""
    h = bytearray(hashlib.sha256(commitment).digest())
    h[0] = BLOB_COMMITMENT_VERSION_KZG
    return bytes(h)


# ---------------- blob <-> polynomial ----------------
def blobs_to_polynomials(es: EthSettings, blobs: Sequence[bytes]):
    """Blobs -> (k, width, 8) Fr words on es.device (one K1 launch for
    all), or None if any blob has the wrong length or an element >= r
    (reference: BlobToPolynomial, eth/helpers.go:264-273)."""
    if any(len(b) != es.width * 32 for b in blobs):
        return None
    if not blobs:
        return fr.zeros((0, es.width), es.device)
    data = b"".join(bytes(b) for b in blobs)
    if not fr.valid_bytes32_batch(data).all():
        return None
    arr, _ = fr.from_bytes32_batch(data, es.device)
    return arr.reshape(len(blobs), es.width, fr.N_WORDS)


def blob_to_polynomial(es: EthSettings, blob: bytes):
    """width * 32 little-endian bytes -> (width, 8) Fr words, or None."""
    polys = blobs_to_polynomials(es, [blob])
    return None if polys is None else polys[0]


def polynomial_to_kzg_commitment(es: EthSettings, poly_dev) -> bytes:
    """The MSM on the bit-reversed Lagrange CRS, compressed (reference:
    PolynomialToKZGCommitment, eth/helpers.go:98-103)."""
    return serialization.compress_g1(
        g1.to_affine_ints_host(es.commit(poly_dev))[0])


def blob_to_kzg_commitment(es: EthSettings, blob: bytes) -> Optional[bytes]:
    """reference: BlobToKZGCommitment (eth/eth.go:145-151)."""
    p = blob_to_polynomial(es, blob)
    if p is None:
        return None
    return polynomial_to_kzg_commitment(es, p)


# ---------------- evaluation ----------------
def _evaluate(es: EthSettings, poly_dev, z: int) -> torch.Tensor:
    """p(z) as Fr words on the device (barycentric, poly.py)."""
    return polyops.eval_poly_in_evaluation_form(
        poly_dev, es.domain, fr.from_int(z, poly_dev.device), es.width_inv)


def evaluate_polynomial_in_evaluation_form(es: EthSettings, poly_dev,
                                           z: int) -> int:
    """Barycentric evaluation on the bit-reversed domain, the canonical
    int (reference: EvaluatePolynomialInEvaluationForm,
    eth/helpers.go:207-211 -> bls/globals.go:106-153)."""
    return int(fr.to_int(_evaluate(es, poly_dev, z)))


# ---------------- Fiat-Shamir ----------------
def _hash_polys_comms(es: EthSettings, polys_dev,
                      comms: Sequence[bytes]) -> bytes:
    """reference: hashPolysComms (eth/helpers.go:235-262)."""
    sha = hashlib.sha256()
    sha.update(FIAT_SHAMIR_PROTOCOL_DOMAIN)
    sha.update(es.width.to_bytes(8, "little"))
    sha.update(len(polys_dev).to_bytes(8, "little"))
    if len(polys_dev):
        sha.update(fr.to_bytes32_batch(polys_dev).tobytes())
    for c in comms:
        sha.update(bytes(c))
    return sha.digest()


def compute_challenges(es: EthSettings, polys_dev, comms: Sequence[bytes]):
    """-> (r_powers as ints, evaluation_challenge int) (reference:
    ComputeChallenges, eth/helpers.go:215-231)."""
    h = _hash_polys_comms(es, polys_dev, comms)
    r = hash_to_bls_field(h + b"\x00")
    evaluation_challenge = hash_to_bls_field(h + b"\x01")
    return compute_powers(r, len(polys_dev)), evaluation_challenge


def _aggregated_poly(es: EthSettings, polys_dev, comms: Sequence[bytes]):
    """-> (sum_i r^i p_i on the device, r^i as device words, challenge)."""
    r_powers, challenge = compute_challenges(es, polys_dev, comms)
    powers_dev = fr.from_int(r_powers, es.device).reshape(-1, fr.N_WORDS)
    return polyops.poly_lin_comb(polys_dev, powers_dev), powers_dev, challenge


def compute_aggregated_poly_and_commitment(es: EthSettings, polys_dev,
                                           comms: Sequence[bytes]):
    """-> (aggregated polynomial on the device, aggregated commitment as
    host affine ints, evaluation challenge int) (reference:
    ComputeAggregatedPolyAndCommitment, eth/helpers.go:137-161). The
    commitment is the variable-base MSM lin_comb_g1 over the decompressed
    commitments."""
    agg_poly, powers_dev, challenge = _aggregated_poly(es, polys_dev, comms)
    comm_pts = [serialization.decompress_g1(bytes(c)) for c in comms]
    agg_comm = g1.to_affine_ints_host(lin_comb_g1(
        g1.from_affine_ints(comm_pts, es.device), powers_dev))[0]
    return agg_poly, agg_comm, challenge


# ---------------- proofs ----------------
def compute_kzg_proof(es: EthSettings, poly_dev, z: int) -> bytes:
    """The quotient (p - y) / (X - z) in evaluation form, its denominators
    in one fr_batch_inv, committed on the Lagrange tables (reference:
    ComputeKZGProof, eth/helpers.go:179-203). y stays on the device."""
    if z % FR_MODULUS in es.domain_set:
        raise ValueError("invalid z challenge: lies in the domain")
    zdev = fr.from_int(z, poly_dev.device)
    y = _evaluate(es, poly_dev, z)
    num = fr.sub(poly_dev, y.expand(poly_dev.shape))
    den = fr.sub(es.domain, zdev.expand(es.domain.shape))
    q = fr.mul(num, fr.batch_inv(den))
    return serialization.compress_g1(
        g1.to_affine_ints_host(es.commit(q))[0])


def compute_aggregate_kzg_proof(es: EthSettings,
                                blobs: Sequence[bytes]) -> bytes:
    """reference: ComputeAggregateKZGProof (eth/eth.go:175-181). The
    blobs' commitments are one batched fixed-base MSM (the blob axis
    rides along as a leading dimension); the aggregated commitment, which
    the proof does not use, is not computed."""
    polys = blobs_to_polynomials(es, blobs)
    if polys is None:
        raise ValueError("could not convert blobs to polynomials")
    if len(polys) == 0:
        # the proof over no blobs: the commitment to the zero polynomial
        return serialization.compress_g1(None)
    comms = [serialization.compress_g1(a)
             for a in g1.to_affine_ints_host(es.commit(polys))]
    agg_poly, _, challenge = _aggregated_poly(es, polys, comms)
    return compute_kzg_proof(es, agg_poly, challenge)


def verify_kzg_proof_from_points(es: EthSettings, commitment_affine, z: int,
                                 y: int, proof_affine) -> bool:
    """e(C - [y]_1, G2) == e(proof, [s - z]_2) on the host (reference:
    VerifyKZGProofFromPoints, eth/helpers.go:55-67)."""
    z2 = host_ec.g2_mul(host_ec.g2_generator(), z % FR_MODULUS)
    y1 = host_ec.g1_mul(host_ec.g1_generator(), y % FR_MODULUS)
    x_minus_z = host_ec.g2_sub(es.setup_g2_1, z2)
    p_minus_y = host_ec.g1_sub(commitment_affine, y1)
    return pairing.pairings_verify(host_ec.g1_neg(p_minus_y),
                                   host_ec.g2_generator(), proof_affine,
                                   x_minus_z)


def verify_kzg_proof(es: EthSettings, commitment: bytes, z32: bytes,
                     y32: bytes, proof: bytes) -> bool:
    """reference: VerifyKZGProof (eth/eth.go:114-134). Raises on malformed
    inputs, returns False on a failing pairing check."""
    z = bytes_to_bls_field(z32)
    if z is None:
        raise ValueError("invalid evaluation point")
    y = bytes_to_bls_field(y32)
    if y is None:
        raise ValueError("invalid expected output")
    c = serialization.decompress_g1(bytes(commitment))
    p = serialization.decompress_g1(bytes(proof))
    return verify_kzg_proof_from_points(es, c, z, y, p)


def verify_aggregate_kzg_proof(es: EthSettings, blobs: Sequence[bytes],
                               comms: Sequence[bytes],
                               aggregated_proof: bytes) -> bool:
    """reference: VerifyAggregateKZGProof (eth/eth.go:155-171)."""
    polys = blobs_to_polynomials(es, blobs)
    if polys is None:
        raise ValueError("could not convert blobs to polynomials")
    agg_poly, agg_comm, challenge = compute_aggregated_poly_and_commitment(
        es, polys, comms)
    y = evaluate_polynomial_in_evaluation_form(es, agg_poly, challenge)
    proof_pt = serialization.decompress_g1(bytes(aggregated_proof))
    return verify_kzg_proof_from_points(es, agg_comm, challenge, y, proof_pt)


# ---------------- consensus and execution-layer glue ----------------
def point_evaluation_precompile(es: EthSettings, input_: bytes) -> bytes:
    """versioned_hash | z | y | commitment | proof -> the 64-byte constant
    (reference: PointEvaluationPrecompile, eth/eth.go:76-110). Raises
    ValueError on any failure (the precompile reverts)."""
    if len(input_) != PRECOMPILE_INPUT_LENGTH:
        raise ValueError("invalid input length")
    versioned_hash = input_[:32]
    z32 = input_[32:64]
    y32 = input_[64:96]
    commitment = input_[96:144]
    proof = input_[144:192]
    if kzg_to_versioned_hash(commitment) != versioned_hash:
        raise ValueError("mismatched versioned hash")
    if not verify_kzg_proof(es, commitment, z32, y32, proof):
        raise ValueError("invalid kzg proof")
    return es.width.to_bytes(32, "big") + FR_MODULUS.to_bytes(32, "big")


def validate_blobs_sidecar(es: EthSettings, slot: int,
                           beacon_block_root: bytes,
                           expected_kzg_commitments: Sequence[bytes],
                           sidecar: BlobsSidecar) -> None:
    """reference: ValidateBlobsSidecar (eth/eth.go:185-208). Raises
    ValueError on any mismatch."""
    if slot != sidecar.beacon_block_slot:
        raise ValueError("slot doesn't match sidecar's beacon block slot")
    if beacon_block_root != sidecar.beacon_block_root:
        raise ValueError("roots not equal")
    if len(sidecar.blobs) != len(expected_kzg_commitments):
        raise ValueError("blob len doesn't match expected commitments len")
    if not verify_aggregate_kzg_proof(es, sidecar.blobs,
                                      expected_kzg_commitments,
                                      sidecar.kzg_aggregated_proof):
        raise ValueError("invalid kzg proof")


def tx_peek_blob_versioned_hashes(tx: bytes) -> List[bytes]:
    """The versioned hashes of a raw blob transaction (reference:
    TxPeekBlobVersionedHashes, eth/eth.go:234-256; offsets at
    eth/eth.go:213-233)."""
    if len(tx) < BLOB_VERSIONED_HASHES_OFFSET + 4:
        raise ValueError("blob tx invalid: too short")
    if tx[0] != BLOB_TX_TYPE:
        raise ValueError("invalid blob tx type")
    offset = int.from_bytes(
        tx[BLOB_VERSIONED_HASHES_OFFSET:BLOB_VERSIONED_HASHES_OFFSET + 4],
        "little") + 70
    if offset > len(tx):
        raise ValueError("offset to versioned hashes is out of bounds")
    rest = len(tx) - offset
    if rest % 32 != 0:
        raise ValueError(
            "expected trailing data starting at versioned-hashes offset "
            "to be a multiple of 32 bytes")
    return [tx[offset + 32 * i:offset + 32 * (i + 1)]
            for i in range(rest // 32)]


def verify_kzg_commitments_against_transactions(
        transactions: Sequence[bytes],
        kzg_commitments: Sequence[bytes]) -> None:
    """reference: VerifyKZGCommitmentsAgainstTransactions
    (eth/eth.go:261-282). Raises ValueError on a mismatch."""
    hashes: List[bytes] = []
    for tx in transactions:
        if len(tx) > 0 and tx[0] == BLOB_TX_TYPE:
            hashes.extend(tx_peek_blob_versioned_hashes(tx))
    if len(kzg_commitments) != len(hashes):
        raise ValueError("invalid number of blob versioned hashes")
    for c, h in zip(kzg_commitments, hashes):
        if kzg_to_versioned_hash(bytes(c)) != h:
            raise ValueError("invalid version hashes vs kzg")
