"""Point compression and decompression in the port against the JAX
package: the golden bytes and flows of tests/test_serialization.py on
both packages' functions, and the batch decompression on the device path
(its plain versions on the CPU: the square roots on `fr_pow`, the subgroup
test on K3) against the recorded `kzg_tpu` batch, including a point off
the subgroup and an invalid encoding; and Fr's bytes32 / ValidFr and bit
functions against kzg_tpu's and Python ints. Exact: affine ints and
bytes."""

import numpy as np
import pytest
from port_helpers import (
    CPU,
    affine_bytes,
    decompress_case,
    reference,
    subgroup_affine,
    wrong_subgroup_g1,
)

from kzg_tpu.curve import serialization as jser
from kzg_tpu.field import fr as jfr
from kzg_tpu_torch.curve import g1, g2, serialization
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.field.constants import FP_MODULUS, FR_MODULUS
from kzg_tpu_torch.utils import host_ec

G1_GEN_COMPRESSED = (
    "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb"
)


def test_g1_generator_golden_bytes():
    g = host_ec.g1_generator()
    assert serialization.g1_to_hex(g) == G1_GEN_COMPRESSED
    assert serialization.g1_from_hex(G1_GEN_COMPRESSED) == g


@pytest.mark.parametrize("k", [2, 3, 12345, FR_MODULUS - 1])
def test_g1_roundtrip_matches_reference(k):
    p = host_ec.g1_mul(host_ec.g1_generator(), k)
    enc = serialization.compress_g1(p)
    assert enc == jser.compress_g1(p)
    assert serialization.decompress_g1(enc) == p == jser.decompress_g1(enc)


def test_infinity_encodings():
    for compress, decompress, size in (
            (serialization.compress_g1, serialization.decompress_g1, 48),
            (serialization.compress_g2, serialization.decompress_g2, 96)):
        b = compress(None)
        assert len(b) == size and b[0] == 0xC0 and not any(b[1:])
        assert decompress(b) is None


@pytest.mark.parametrize("k", [1, 7777])
def test_g2_roundtrip_matches_reference(k):
    q = host_ec.g2_mul(host_ec.g2_generator(), k)
    enc = serialization.compress_g2(q)
    assert enc == jser.compress_g2(q)
    assert serialization.g2_from_hex(enc.hex()) == q == \
        jser.decompress_g2(enc)


def test_g1_invalid_rejected():
    with pytest.raises(ValueError):
        serialization.decompress_g1(b"\x00" * 48)  # no compressed flag
    with pytest.raises(ValueError):
        serialization.decompress_g1(b"\xc0" + b"\x01" + b"\x00" * 46)


def test_wrong_subgroup_rejected_on_host():
    pt = wrong_subgroup_g1()
    assert not serialization.g1_in_subgroup(pt)
    assert not jser.g1_in_subgroup(pt)
    with pytest.raises(ValueError, match="subgroup"):
        serialization.decompress_g1(serialization.compress_g1(pt))
    assert serialization.g1_in_subgroup(host_ec.g1_generator())


def test_device_subgroup_checks():
    """g1.in_subgroup ([r-1]P == -P on K3) and g2.in_subgroup (on K-a)
    against the host test."""
    good = subgroup_affine(91, 2) + [None]
    pts = g1.from_affine_ints(good + [wrong_subgroup_g1()], CPU)
    assert g1.in_subgroup(pts).tolist() == [True, True, True, False]
    q = host_ec.g2_mul(host_ec.g2_generator(), 5)
    assert g2.in_subgroup(g2.from_affine_ints([q, None], CPU)).tolist() \
        == [True, True]


def test_decompress_batch_matches_recorded():
    pts, good, off, bad = decompress_case()
    got = serialization.decompress_g1_batch(good, device=CPU)
    assert got == pts
    want = reference("decompress:good", *good)
    np.testing.assert_array_equal(affine_bytes(got), want)


def test_decompress_batch_rejects_like_reference():
    _, _, off, bad = decompress_case()
    got = serialization.decompress_g1_batch([off], subgroup_check=False,
                                            device=CPU)
    assert got == [wrong_subgroup_g1()]
    np.testing.assert_array_equal(
        affine_bytes(got), reference("decompress:off_unchecked", off))
    for key, enc in (("decompress:off", off), ("decompress:bad", bad)):
        msg = str(reference(key, enc))
        with pytest.raises(ValueError) as e:
            serialization.decompress_g1_batch([enc], device=CPU)
        assert str(e.value) == msg
    assert "subgroup" in str(reference("decompress:off", off))
    assert int.from_bytes(bad, "big") & ((1 << 381) - 1) >= FP_MODULUS


def test_fr_bytes_and_bits():
    vals = [0, 1, 12345, FR_MODULUS - 1, FR_MODULUS, (1 << 256) - 1]
    data = b"".join(v.to_bytes(32, "little") for v in vals)
    valid = fr.valid_bytes32_batch(data)
    assert valid.tolist() == jfr.valid_bytes32_batch(data).tolist() == \
        [True, True, True, True, False, False]
    mont, ok = fr.from_bytes32_batch(data, CPU)
    assert ok.tolist() == valid.tolist()
    assert [int(v) for v in fr.to_int(mont)[:4]] == vals[:4]
    assert fr.to_bytes32_batch(mont[:4]).tobytes() == data[:128]
    for v in vals:
        b = v.to_bytes(32, "little")
        assert fr.valid_fr_bytes(b) == jfr.valid_fr_bytes(b)
        x = fr.from_bytes32_le(b, CPU)
        assert (x is None) == (v >= FR_MODULUS)
        if x is not None:
            assert fr.to_bytes32_le(x) == b
    bits = fr.scalar_bits(fr.from_int(vals[:4], CPU))
    assert [sum(int(b) << i for i, b in enumerate(row)) for row in bits] \
        == vals[:4]
