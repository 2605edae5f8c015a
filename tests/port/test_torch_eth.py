"""The port's EIP-4844 API (kzg_tpu_torch.eth) against kzg_tpu.eth.

The calls of port_helpers.eth_cases (eth_env's insecure setup at width
16 and three seeded blobs: commitments, evaluations on and off the
domain, proofs, the Fiat-Shamir challenges, the aggregated commitment
and proof, the precompile, sidecar validation, transaction checks, and
the edge cases: zero blobs, an element >= r, a short blob, z on the
domain, a wrong versioned hash, tampered y, proofs, blobs and sidecars)
give the recorded kzg_tpu outcomes exactly: the same bytes, ints and
verdicts, and the same exception with the same message, except that an
IndexError from the array library (kzg_tpu's reaction to an aggregate
check over no blobs) is compared by its type. The pure host helpers are
compared live with kzg_tpu's. Runs on the CPU (device="cpu"): the kernel
wrappers take their plain versions.
"""

import hashlib
import json

import pytest
from port_helpers import (
    CPU,
    ETH_SECRET,
    ETH_WIDTH,
    blob_tx,
    eth_blobs,
    eth_cases,
    reference,
)

from kzg_tpu_torch import eth
from kzg_tpu_torch.curve import g1, serialization
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus


@pytest.fixture(scope="module")
def es():
    return eth.EthSettings.insecure(ETH_SECRET, ETH_WIDTH, device=CPU)


def _comparable(text: str) -> str:
    if text.startswith("raise IndexError"):
        return "raise IndexError"
    return text


def test_eth_cases_equal_reference(es):
    blobs = eth_blobs()
    got = eth_cases(eth, fr.to_int, es, blobs)
    want = {name: str(reference(f"eth:{name}", ETH_SECRET, ETH_WIDTH,
                                *blobs)) for name in got}
    diff = {k: (got[k][:120], want[k][:120]) for k in got
            if _comparable(got[k]) != _comparable(want[k])}
    assert not diff, diff
    assert want["verify"] == "ok True" and want["sidecar"] == "ok None"


def test_exports_match_reference():
    import kzg_tpu.eth as ref

    names = {n for n in dir(ref) if not n.startswith("_")} - {
        "api", "settings"}
    assert names <= set(dir(eth))
    for n in ("FIELD_ELEMENTS_PER_BLOB", "BLOB_COMMITMENT_VERSION_KZG",
              "BLOB_TX_TYPE", "BLOB_VERSIONED_HASHES_OFFSET",
              "FIAT_SHAMIR_PROTOCOL_DOMAIN", "PRECOMPILE_INPUT_LENGTH"):
        assert getattr(eth, n) == getattr(ref, n)


@pytest.mark.parametrize("b32", [b"\x00" * 32, (R - 1).to_bytes(32, "little"),
                                 R.to_bytes(32, "little"), b"\xff" * 32,
                                 (12345).to_bytes(32, "little")])
def test_bytes_to_bls_field(b32):
    import kzg_tpu.eth as ref

    assert eth.bytes_to_bls_field(b32) == ref.bytes_to_bls_field(b32)


@pytest.mark.parametrize("data", [b"", b"hello world", bytes(range(200))])
def test_hash_to_bls_field_and_versioned_hash(data):
    import kzg_tpu.eth as ref

    assert eth.hash_to_bls_field(data) == ref.hash_to_bls_field(data) == \
        int.from_bytes(hashlib.sha256(data).digest(), "little") % R
    assert eth.kzg_to_versioned_hash(data) == ref.kzg_to_versioned_hash(data)


def test_compute_powers():
    import kzg_tpu.eth as ref

    for r_, n in ((7, 5), (R - 1, 4), (0, 3), (123456789, 0)):
        assert eth.compute_powers(r_, n) == ref.compute_powers(r_, n)


def _peek(mod, tx):
    try:
        return mod.tx_peek_blob_versioned_hashes(tx)
    except ValueError as e:
        return f"ValueError: {e}"


def test_tx_peek_blob_versioned_hashes():
    import kzg_tpu.eth as ref

    hashes = [bytes([i]) * 32 for i in range(1, 4)]
    tx = blob_tx(eth, hashes, payload_offset=300)
    wrong_type = bytes([1]) + tx[1:]
    far = bytearray(tx)
    far[eth.BLOB_VERSIONED_HASHES_OFFSET:
        eth.BLOB_VERSIONED_HASHES_OFFSET + 4] = (10 ** 6).to_bytes(4, "little")
    for t in (tx, tx + b"\x00", wrong_type, bytes(far),
              b"\x05" + b"\x00" * 100, blob_tx(eth, [])):
        assert _peek(eth, t) == _peek(ref, t)
    assert _peek(eth, tx) == hashes


def test_from_json_reads_a_setup_file(es, tmp_path):
    """A ceremony file of the reference's schema written from the insecure
    setup loads back to the same points (decompress_g1_batch, with the
    subgroup check, and the G2 parser)."""
    data = {
        "setup_G1": [serialization.g1_to_hex(p)
                     for p in es.setup_g1_affine],
        "setup_G2": [serialization.g2_to_hex(host_ec.g2_generator()),
                     serialization.g2_to_hex(es.setup_g2_1)],
        "setup_G1_lagrange": [serialization.g1_to_hex(p) for p in
                              _natural(es.lagrange_affine_brp)],
    }
    path = tmp_path / "trusted_setup.json"
    path.write_text(json.dumps(data))
    loaded = eth.EthSettings.from_json(str(path), device=CPU)
    assert loaded.width == es.width
    assert loaded.lagrange_affine_brp == es.lagrange_affine_brp
    assert loaded.setup_g1_affine == es.setup_g1_affine
    assert loaded.setup_g2_1 == es.setup_g2_1
    assert loaded.domain_ints == es.domain_ints


def _natural(brp: list) -> list:
    from kzg_tpu_torch.ntt import bit_reversal_indices

    out = [None] * len(brp)
    for i, j in enumerate(bit_reversal_indices(len(brp))):
        out[int(j)] = brp[i]
    return out


def test_settings_tables_and_batched_commit(es):
    """lagrange_tables are built once; the commitments of a batch of
    blobs equal the one-blob commitments."""
    blobs = eth_blobs()
    polys = eth.blobs_to_polynomials(es, blobs)
    assert polys.shape == (3, ETH_WIDTH, fr.N_WORDS)
    assert es.lagrange_tables is es.lagrange_tables
    batch = [serialization.compress_g1(a)
             for a in g1.to_affine_ints_host(es.commit(polys))]
    assert batch == [eth.blob_to_kzg_commitment(es, b) for b in blobs]
    assert eth.blobs_to_polynomials(es, []).shape == (0, ETH_WIDTH,
                                                      fr.N_WORDS)
