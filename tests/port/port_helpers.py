"""Helpers shared by the port's tests (tests/port/test_torch_*.py).

The same inputs, made from a numpy seed, go through the JAX package (on
its CPU "vector" engine, as the JAX tests run it) and through
kzg_tpu_torch with device="cpu", where every kernel wrapper runs its
plain version. Tolerance is exact: field values are compared as canonical
ints (or as the same words after the 16 <-> 32-bit repack), G1 points in
affine form with None for infinity.

The JAX package's G1 paths and Fr FFTs compile for a minute or more each
on the CPU, which would crowd the JAX suite out of its time limit. For
those, make_reference.py runs the JAX package once on the inputs built
here and records its outputs in reference_outputs.npz. The JAX package is
frozen (the port may not edit it), so its recorded outputs stand for it.
Each record carries a hash of its inputs, which the tests check.
"""

import functools
import hashlib
import os

import numpy as np

CPU = "cpu"
REFERENCE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "reference_outputs.npz")
# kzg_env's secret and CRS size (tests/conftest.py), tests/test_fk20.py's
# polynomial and widths
TEST_SECRET = 1927409816240961209460912649124
CRS_SIZE = 17
FK20_COEFFS = [1, 2, 3, 4, 7, 8, 9, 10]
FK20_N, FK20_N2 = 8, 16
FK20_CHUNKS = (2, 4)
FFT_SCALES = tuple(range(4, 11))


def random_ints(rng, n: int, modulus: int) -> list:
    """n uniform ints mod `modulus` from five 63-bit draws each."""
    w = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a + (b << 63) + (c << 126) + (d << 189) + (e << 252)) % modulus
            for a, b, c, d, e in w]


def edge_ints(modulus: int) -> list:
    """Values at the ends of the range, where a final reduction matters."""
    return [0, 1, 2, modulus - 1, modulus - 2, modulus - 3,
            modulus - (1 << 32), modulus - (1 << 200), (1 << 255) % modulus,
            (1 << 256) % modulus, modulus >> 1]


def port_to_ref(p):
    """Port JacobianPoint -> JAX package JacobianPoint (jnp arrays)."""
    import jax.numpy as jnp
    from kzg_tpu.curve.weierstrass import JacobianPoint as RefPoint

    from kzg_tpu_torch import convert

    return RefPoint(*(jnp.asarray(c) for c in convert.point_to_ref(p)))


def ref_to_port(p):
    """JAX package JacobianPoint -> port JacobianPoint on the CPU."""
    from kzg_tpu_torch import convert

    return convert.point_from_ref(*(np.asarray(c) for c in p), device=CPU)


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def eval_poly(coeffs, x: int, m: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % m
    return acc


def coset_proofs_oracle(coeffs, n_dom: int, l: int, secret: int,
                        rbo: bool) -> list:
    """Coset proofs by definition, over Python ints: proof j is [q(s)]G
    with q = f div (X^l - x0^l), x0 = w^j for the n_dom/l cosets of the
    n_dom-th roots of unity (w^bitrev(j) when `rbo`)."""
    from kzg_tpu_torch.field.constants import FR_MODULUS as r
    from kzg_tpu_torch.utils import host_ec

    n = len(coeffs)
    k = n_dom // l
    bits = (k - 1).bit_length()
    w = pow(7, (r - 1) // n_dom, r)
    s = secret % r
    g = host_ec.g1_generator()
    out = []
    for j in range(k):
        c = pow(pow(w, bitrev(j, bits) if rbo else j, r), l, r)
        q = [0] * n
        for i in range(n - 1 - l, -1, -1):
            q[i] = (coeffs[i + l] + c * (q[i + l] if i + l < n else 0)) % r
        out.append(host_ec.g1_mul(g, eval_poly(q, s, r)))
    return out


# ---- inputs of the recorded comparisons (make_reference.py) ----
def _r():
    from kzg_tpu_torch.field.constants import FR_MODULUS

    return FR_MODULUS


def fft_input(scale: int) -> list:
    return random_ints(np.random.default_rng(scale), 1 << scale, _r())


def subgroup_affine(seed: int, n: int) -> list:
    """n r-torsion points k_i G as affine ints."""
    from kzg_tpu_torch.utils import host_ec

    g = host_ec.g1_generator()
    return [host_ec.g1_mul(g, k)
            for k in random_ints(np.random.default_rng(seed), n, _r())]


def with_zero_infinity(p, lane: int):
    """Lane `lane` set to all-zero words, the ladders' infinity."""
    from kzg_tpu_torch.curve.weierstrass import JacobianPoint

    out = JacobianPoint(*(c.clone() for c in p))
    for c in out:
        c[lane] = 0
    return out


def mul_case():
    """5 lanes, the batch of the JAX package's own g1.mul tests: a random
    point and scalar, infinity as (1, 1, 0) and as all-zero words, and
    the scalars 0, 1 and r-1. -> (affine, port points, scalars)."""
    from kzg_tpu_torch.curve import g1

    aff = subgroup_affine(2, 5)
    aff[1] = aff[2] = None
    pts = with_zero_infinity(g1.from_affine_ints(aff, CPU), 2)
    r = _r()
    ks = random_ints(np.random.default_rng(3), 2, r) + [0, 1, r - 1]
    return aff, pts, ks


def fft_g1_case():
    """8 points for the width-8 G1 FFT on a width-32 domain: the shape of
    part 1 in the l = 2 FK20 settings."""
    from kzg_tpu_torch.curve import g1

    aff = subgroup_affine(18, 8)
    return aff, g1.from_affine_ints(aff, CPU)


def tree_reduce_case():
    """(3, 2) points: an odd row count."""
    from kzg_tpu_torch.curve import g1
    from kzg_tpu_torch.curve.weierstrass import JacobianPoint

    aff = subgroup_affine(33, 6)
    pts = g1.from_affine_ints(aff, CPU)
    return aff, JacobianPoint(*(c.reshape(3, 2, 12) for c in pts))


def jacobian_points(aff, seed: int):
    """Port batch of affine points (None: infinity as (1, 1, 0)) in
    Jacobian form (x l^2, y l^3, l) with random l, so that Z != 1."""
    from kzg_tpu_torch.curve.weierstrass import JacobianPoint
    from kzg_tpu_torch.field import fp

    p = fp.SPEC.modulus
    lams = random_ints(np.random.default_rng(seed), len(aff), p)
    cols = [(1, 1, 0) if c is None else
            (c[0] * l * l % p, c[1] * pow(l, 3, p) % p, l)
            for c, l in zip(aff, lams)]
    return JacobianPoint(*(fp.from_int(list(v), CPU) for v in zip(*cols)))


def g1_add_case():
    """8-lane (P, Q) for the complete add, the edge cases of
    tests/test_pallas_g1.py:64-79 with Z != 1: P+P (the same point under
    two Z), P+(-P), a generic sum, P+inf and inf+Q with inf as (1, 1, 0)
    and as all-zero words, and inf+inf. -> (p_aff, q_aff, p, q)."""
    from kzg_tpu_torch.utils import host_ec

    a = subgroup_affine(50, 8)
    p_aff = [a[0], a[1], a[2], a[3], a[4], None, None, None]
    q_aff = [a[0], host_ec.g1_neg(a[1]), a[5], None, None, a[6], a[7], None]
    p = with_zero_infinity(jacobian_points(p_aff, 51), 6)
    q = with_zero_infinity(jacobian_points(q_aff, 52), 4)
    return p_aff, q_aff, p, q


def msm_scalars() -> list:
    """(2, CRS_SIZE) scalars: two MSMs over the 17-point CRS, the first
    starting with 0, 1 and r-1."""
    r = _r()
    ks = random_ints(np.random.default_rng(60), 2 * CRS_SIZE, r)
    ks[:3] = [0, 1, r - 1]
    return [ks[:CRS_SIZE], ks[CRS_SIZE:]]


# (log2 n, domain scale) of the recorded DAS extensions: the two sizes of
# tests/test_field_backends.py:93, n = 64 crossing the reference's
# reduce_hi boundary (6 down levels)
DAS_CASES = ((3, 4), (6, 8))


def das_input(log_n: int) -> list:
    return random_ints(np.random.default_rng(70 + log_n), 1 << log_n, _r())


def slice_evens() -> list:
    """The whole slice's 8 evens on kzg_env's width-32 domain: the FK20
    polynomial at w^(2i), w the 16th root of unity. Their extension's
    inverse FFT is FK20_COEFFS padded with 8 zeros."""
    from kzg_tpu_torch.field.constants import fr_scale2_root_of_unity

    r = _r()
    w = fr_scale2_root_of_unity(4)
    return [eval_poly(FK20_COEFFS, pow(w, 2 * i, r), r) for i in range(FK20_N)]


def butterfly_input(modulus: int) -> list:
    """(a, b, tw) of 200 lanes each, the width of
    tests/test_field_backends.py:78-89, with the edge values in the first
    lanes of each."""
    rng = np.random.default_rng(100 + modulus % 97)
    edges = edge_ints(modulus)
    return [edges[k:] + edges[:k] + random_ints(rng, 200 - len(edges),
                                                 modulus)
            for k in range(3)]


def batch_inv_input() -> list:
    """13 lanes (tests/test_das.py:88-95) with zero in lanes 3 and 9."""
    vals = random_ints(np.random.default_rng(17), 13, _r())
    vals[3] = vals[9] = 0
    return vals


# tests/test_poly.py's cases: points and shapes; values from poly_case
POLY_Z = 987123          # a quotient point off the 16th roots of unity
POLY_X = 777777          # a barycentric evaluation point
POWERS_X, POWERS_N = 12345, 9


def poly_case() -> dict:
    """Seeded inputs of tests/test_poly.py's cases, as canonical ints."""
    rng = np.random.default_rng(110)
    r = _r()
    q = random_ints(rng, 9, r)
    z = random_ints(rng, 1, r)[0]
    p = [0] * 10                      # p = q (x - z), divisible by x - z
    for i, c in enumerate(q):
        p[i + 1] = (p[i + 1] + c) % r
        p[i] = (p[i] - c * z) % r
    return {"coeffs": random_ints(rng, 13, r), "xs": random_ints(rng, 4, r),
            "sum": random_ints(rng, 7, r),
            "polys": [random_ints(rng, 8, r) for _ in range(3)],
            "scalars": random_ints(rng, 3, r), "q": q, "z": z, "p": p,
            "dividend": random_ints(rng, 12, r),
            "divisor": random_ints(rng, 4, r),
            "c16": random_ints(rng, 16, r)}


# tests/test_das.py's zero-polynomial and recovery cases
ZERO_POLY_CASES = ((4, 0.25), (5, 0.5), (6, 0.75))
RECOVERY_CASES = ((1, 0.5), (2, 0.7), (3, 0.95))
# (scale, seed) of the legacy parity case and the legacy-vs-modern one,
# each with half the lanes missing
LEGACY_CASES = ((4, 4), (5, 14))


def zero_poly_missing(scale: int, ratio: float) -> list:
    """The missing indices of test_zero_poly_vs_oracle."""
    n = 1 << scale
    m = min(max(1, int(n * ratio)), n - 1)
    rng = np.random.default_rng(scale)
    return sorted(rng.choice(n, size=m, replace=False).tolist())


def tree_missing() -> list:
    """Half of 256 indices missing: 128 > 64 factors, two leaves and one
    tree level (test_zero_poly_multi_leaf_tree)."""
    rng = np.random.default_rng(88)
    return sorted(rng.choice(256, size=128, replace=False).tolist())


def erasure_coded(scale: int, rng) -> list:
    """The evaluations of a random polynomial of degree < n/2 on the
    2^scale domain (tests/oracle.py's FFT)."""
    import oracle

    n = 1 << scale
    coeffs = [int(rng.integers(0, 2**62)) % _r() for _ in range(n // 2)]
    return oracle.fft(coeffs + [0] * (n // 2))


def recovery_case(seed: int, known_ratio: float, scale: int = 5):
    """test_recover_poly_from_samples's inputs: (evals, samples with 0 in
    the missing lanes, missing)."""
    n = 1 << scale
    rng = np.random.default_rng(seed)
    evals = erasure_coded(scale, rng)
    n_missing = min(n - int(n * known_ratio), n // 2)
    missing = sorted(rng.choice(n, size=n_missing, replace=False).tolist())
    samples = [0 if i in missing else v for i, v in enumerate(evals)]
    return evals, samples, missing


def erasure_only_case():
    """test_recover_is_erasure_only: two missing lanes, and a corrupted
    known sample (lane 7) that recovery must reproduce verbatim."""
    evals = erasure_coded(4, np.random.default_rng(9))
    samples = list(evals)
    samples[7] = (samples[7] + 1) % _r()
    return samples, [0, 3]


# tests/test_kzg.py's polynomial and points
PROOF_COEFFS = [1, 2, 3, 4, 7, 7, 7, 7, 13, 13, 13, 13, 13, 13, 13, 13]
PROOF_X = 17
MULTI_X, MULTI_N = 5, 4


def inputs_hash(*inputs) -> str:
    """sha256 of arrays (shape and bytes) and plain values (repr)."""
    h = hashlib.sha256()
    for a in inputs:
        if isinstance(a, (int, str, list, tuple)):
            h.update(repr(a).encode())
        else:
            a = np.ascontiguousarray(np.asarray(a))
            h.update(str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _reference_file():
    with np.load(REFERENCE_FILE) as f:
        return {k: f[k] for k in f.files}


def reference(key: str, *inputs):
    """The recorded JAX output `key` (an array, or a JAX-layout point batch
    for a key recorded as key:x, key:y, key:z), after checking that
    `inputs` are the ones it was recorded on."""
    rec = _reference_file()
    assert str(rec[key + ":inputs"]) == inputs_hash(*inputs), \
        f"{key}: inputs changed; rerun tests/port/make_reference.py"
    if key in rec:
        return rec[key]
    return tuple(rec[f"{key}:{c}"] for c in "xyz")


# ---- the verification group (tests/port/test_torch_serialization.py,
# test_torch_pairing.py, test_torch_verify.py) ----
def wrong_subgroup_g1():
    """The first on-curve G1 point (x, sqrt(x^3 + 4)), x < 100, outside the
    r-order subgroup (tests/test_serialization.py:51-66)."""
    from kzg_tpu_torch.field.constants import FP_MODULUS as p
    from kzg_tpu_torch.utils import host_ec

    for x in range(1, 100):
        y2 = (pow(x, 3, p) + 4) % p
        y = pow(y2, (p + 1) // 4, p)
        if y * y % p == y2 and host_ec.g1_mul((x, y), _r()) is not None:
            return (x, y)
    raise AssertionError("no wrong-subgroup point found")


def decompress_case():
    """(points, their 48-byte encodings: 5 subgroup points, one with the
    larger y, and infinity; the encoding of an on-curve point off the
    subgroup; an invalid encoding, x >= p)."""
    from kzg_tpu_torch.curve import serialization
    from kzg_tpu_torch.field.constants import FP_MODULUS as p

    pts = subgroup_affine(90, 5) + [None]
    big = next(i for i, q in enumerate(pts[:5]) if q[1] > (p - 1) // 2)
    assert big is not None
    good = [serialization.compress_g1(q) for q in pts]
    off = serialization.compress_g1(wrong_subgroup_g1())
    bad = bytes([0x80 | 0x1F]) + b"\xff" * 47
    return pts, good, off, bad


def affine_bytes(points) -> np.ndarray:
    """G1 affine ints / None -> uint8 (n, 97): x and y big-endian, then 1
    for infinity (the recorded form of a decompressed batch)."""
    out = np.zeros((len(points), 97), dtype=np.uint8)
    for i, q in enumerate(points):
        if q is None:
            out[i, 96] = 1
        else:
            out[i, :96] = list(q[0].to_bytes(48, "big")
                               + q[1].to_bytes(48, "big"))
    return out


def random_f12_ints(seed: int, n: int) -> list:
    """n random Fp12 values as nested ints [w][v][u] (Fp12 = Fp6 + Fp6 w,
    Fp6 = 3 Fp2, Fp2 = 2 Fp)."""
    from kzg_tpu_torch.field.constants import FP_MODULUS as p

    v = random_ints(np.random.default_rng(seed), 12 * n, p)
    return [[[[v[12 * i + 6 * j + 2 * k], v[12 * i + 6 * j + 2 * k + 1]]
              for k in range(3)] for j in range(2)] for i in range(n)]


FEXP_LANES = 3


def miller_case():
    """Two lanes of (P, Q): P = a G1, Q = b G2 for seeded a, b."""
    from kzg_tpu_torch.utils import host_ec

    ks = random_ints(np.random.default_rng(120), 4, _r())
    return [(host_ec.g1_mul(host_ec.g1_generator(), ks[2 * i]),
             host_ec.g2_mul(host_ec.g2_generator(), ks[2 * i + 1]))
            for i in range(2)]


# tests/test_pairing_device.py:116-147's batch: kzg_env, the polynomial,
# the coset width and the coset offsets; lane 2's ys are each off by one
BATCH_COEFFS = [1, 2, 3, 4, 7, 8, 9, 10]
BATCH_M = 4
BATCH_XS = [5, 11, 13]


def batch_case():
    """-> ys rows (3, 4) as ints: p(x w^i) on each coset, lane 2 + 1."""
    r = _r()
    w = pow(7, (r - 1) // BATCH_M, r)
    rows = [[eval_poly(BATCH_COEFFS, x * pow(w, i, r) % r, r)
             for i in range(BATCH_M)] for x in BATCH_XS]
    rows[2] = [(v + 1) % r for v in rows[2]]
    return rows


def multi_case() -> list:
    """tests/test_kzg.py:62-73's ys on the coset MULTI_X <w_4> of
    PROOF_COEFFS, then the same each + 1."""
    r = _r()
    w = pow(7, (r - 1) // MULTI_N, r)
    ys = [eval_poly(PROOF_COEFFS, MULTI_X * pow(w, i, r) % r, r)
          for i in range(MULTI_N)]
    return [ys, [(v + 1) % r for v in ys]]


# ---- the eth group (tests/port/test_torch_eth.py): tests/conftest.py's
# eth_env, three seeded blobs, and the calls of eth_cases ----
ETH_SECRET, ETH_WIDTH = 424242424242, 16
ETH_Z = 987654321
ETH_SLOT, ETH_ROOT = 5, b"\x11" * 32


def eth_blobs() -> list:
    """Three blobs of ETH_WIDTH canonical field elements, 32 little-endian
    bytes each."""
    rng = np.random.default_rng(140)
    return [b"".join(v.to_bytes(32, "little")
                     for v in random_ints(rng, ETH_WIDTH, _r()))
            for _ in range(3)]


def blob_tx(eth, hashes, payload_offset: int = 192) -> bytes:
    """A minimal blob transaction whose versioned hashes sit at
    `payload_offset` past byte 70 (tests/test_eth.py:116-138), with the
    constants of the eth module given."""
    off = eth.BLOB_VERSIONED_HASHES_OFFSET
    tx = bytearray(70 + payload_offset + 32 * len(hashes))
    tx[0] = eth.BLOB_TX_TYPE
    tx[off:off + 4] = payload_offset.to_bytes(4, "little")
    for i, h in enumerate(hashes):
        tx[70 + payload_offset + 32 * i:70 + payload_offset + 32 * (i + 1)] \
            = h
    return bytes(tx)


def outcome(fn, *args) -> str:
    """A call's result as text: "ok <value>" (bytes in hex) or
    "raise <type>: <message>"."""
    try:
        v = fn(*args)
    except Exception as e:  # noqa: BLE001  (the outcome is the record)
        return f"raise {type(e).__name__}: {e}"
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v).hex()
    return f"ok {v}"


def eth_cases(eth, fr_to_int, es, blobs) -> dict:
    """The eth group's calls on `es` and `blobs`, the same for kzg_tpu.eth
    and kzg_tpu_torch.eth: name -> outcome text. fr_to_int reads a
    polynomial of the package as canonical ints."""
    r = _r()
    out = {}

    def run(name, fn, *args):
        out[name] = outcome(fn, *args)

    out["lagrange_brp"] = str(es.lagrange_affine_brp)
    out["setup_g1"] = str(es.setup_g1_affine)
    out["setup_g2_1"] = str(es.setup_g2_1)
    out["domain"] = str(es.domain_ints)
    comms = [eth.blob_to_kzg_commitment(es, b) for b in blobs]
    out["commitments"] = " ".join(c.hex() for c in comms)
    p0 = eth.blob_to_polynomial(es, blobs[0])
    out["poly0"] = str([int(v) for v in fr_to_int(p0)])
    z = ETH_Z
    y = eth.evaluate_polynomial_in_evaluation_form(es, p0, z)
    out["y"] = str(y)
    on = es.domain_ints[3]
    run("y_on_domain", eth.evaluate_polynomial_in_evaluation_form, es, p0, on)
    proof = eth.compute_kzg_proof(es, p0, z)
    out["proof"] = proof.hex()
    run("proof_on_domain", eth.compute_kzg_proof, es, p0, on)
    z32, y32 = z.to_bytes(32, "little"), y.to_bytes(32, "little")
    y1 = ((y + 1) % r).to_bytes(32, "little")
    run("verify", eth.verify_kzg_proof, es, comms[0], z32, y32, proof)
    run("verify_wrong_y", eth.verify_kzg_proof, es, comms[0], z32, y1, proof)
    run("verify_wrong_proof", eth.verify_kzg_proof, es, comms[0], z32, y32,
        comms[1])
    run("verify_z_ge_r", eth.verify_kzg_proof, es, comms[0],
        r.to_bytes(32, "little"), y32, proof)
    run("verify_bad_point", eth.verify_kzg_proof, es, comms[0], z32, y32,
        b"\x00" * 48)
    polys = eth.blobs_to_polynomials(es, blobs)
    run("challenges", eth.compute_challenges, es, polys, comms)
    run("aggregated", lambda: eth.compute_aggregated_poly_and_commitment(
        es, polys, comms)[1:])
    agg = eth.compute_aggregate_kzg_proof(es, blobs)
    out["aggregate_proof"] = agg.hex()
    run("verify_aggregate", eth.verify_aggregate_kzg_proof, es, blobs,
        comms, agg)
    bad = bytearray(blobs[0])
    bad[0] ^= 1
    run("verify_aggregate_tampered_blob", eth.verify_aggregate_kzg_proof,
        es, [bytes(bad)] + blobs[1:], comms, agg)
    run("verify_aggregate_tampered_proof", eth.verify_aggregate_kzg_proof,
        es, blobs, comms, proof)
    vh = eth.kzg_to_versioned_hash(comms[0])
    inp = vh + z32 + y32 + comms[0] + proof
    run("precompile", eth.point_evaluation_precompile, es, inp)
    run("precompile_wrong_hash", eth.point_evaluation_precompile, es,
        b"\x00" * 32 + inp[32:])
    run("precompile_wrong_y", eth.point_evaluation_precompile, es,
        vh + z32 + y1 + comms[0] + proof)
    run("precompile_short", eth.point_evaluation_precompile, es, inp[:-1])
    side = eth.BlobsSidecar(ETH_ROOT, ETH_SLOT, blobs, agg)
    run("sidecar", eth.validate_blobs_sidecar, es, ETH_SLOT, ETH_ROOT, comms,
        side)
    run("sidecar_wrong_slot", eth.validate_blobs_sidecar, es, ETH_SLOT + 1,
        ETH_ROOT, comms, side)
    run("sidecar_wrong_root", eth.validate_blobs_sidecar, es, ETH_SLOT,
        b"\x22" * 32, comms, side)
    run("sidecar_too_few_commitments", eth.validate_blobs_sidecar, es,
        ETH_SLOT, ETH_ROOT, comms[:2], side)
    run("sidecar_tampered", eth.validate_blobs_sidecar, es, ETH_SLOT,
        ETH_ROOT, comms, eth.BlobsSidecar(ETH_ROOT, ETH_SLOT, blobs, proof))
    run("aggregate_zero_blobs", eth.compute_aggregate_kzg_proof, es, [])
    run("verify_aggregate_zero_blobs", eth.verify_aggregate_kzg_proof, es,
        [], [], bytes([0xC0]) + bytes(47))
    big = bytearray(blobs[1])
    big[32:64] = r.to_bytes(32, "little")
    run("commit_element_ge_r", eth.blob_to_kzg_commitment, es, bytes(big))
    run("aggregate_element_ge_r", eth.compute_aggregate_kzg_proof, es,
        [blobs[0], bytes(big)])
    run("commit_short_blob", eth.blob_to_kzg_commitment, es, blobs[0][:-32])
    tx = blob_tx(eth, [vh])
    run("txs", eth.verify_kzg_commitments_against_transactions, [tx],
        [comms[0]])
    run("txs_wrong_hash", eth.verify_kzg_commitments_against_transactions,
        [tx], [comms[1]])
    run("txs_short", eth.verify_kzg_commitments_against_transactions,
        [bytes([eth.BLOB_TX_TYPE]) + bytes(100)], [])
    return out


# ---- the generic G1 FFT (tests/port/test_torch_fft_g1_generic.py) ----
def off_subgroup_affine(n: int) -> list:
    """n points of E(Fp) from seeded x by a square root, none of them in
    the r-torsion, with lane 3 at infinity."""
    from kzg_tpu_torch.field.constants import FP_MODULUS as p
    from kzg_tpu_torch.utils import host_ec

    rng = np.random.default_rng(150)
    out = []
    while len(out) < n:
        x = random_ints(rng, 1, p)[0]
        y2 = (pow(x, 3, p) + 4) % p
        y = pow(y2, (p + 1) // 4, p)
        if y * y % p == y2 and host_ec.g1_mul((x, y), _r()) is not None:
            out.append((x, y))
    out[3] = None
    return out


def off_subgroup_case(n: int):
    """(affine, port points in Jacobian form with Z != 1) of n points."""
    aff = off_subgroup_affine(16)[:n]
    return aff, jacobian_points(aff, 151)


FFT_G1_GENERIC_SCALE = 4


# ---- the sharded paths (tests/port/test_torch_parallel.py) ----
PAR_DS = (2, 4)          # the ranks of the "elem" axis
PAR_SCALE = 6            # their FFTSettings: a width-64 domain
PAR_FFT_N = 32
PAR_G1_N = 16
PAR_MSM_NS = (16, 12)    # 12 points at D = 4: an odd block of 3
PAR_CORE_N = 8           # the local G1 inverse with the global 1/16


def parallel_fft_input() -> list:
    return random_ints(np.random.default_rng(170), PAR_FFT_N, _r())


def parallel_g1_case(n: int):
    """(affine, port points with Z != 1) of n r-torsion points."""
    aff = subgroup_affine(171, n)
    return aff, jacobian_points(aff, 172)


def parallel_msm_scalars(n: int) -> list:
    r = _r()
    ks = random_ints(np.random.default_rng(173), n, r)
    ks[:3] = [0, 1, r - 1]
    return ks
