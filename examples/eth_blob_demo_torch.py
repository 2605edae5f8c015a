"""The EIP-4844 blob pipeline on kzg_tpu_torch, at the production width of
4096 field elements, on the card.

blob -> commitment -> point-evaluation proof -> verification -> the
precompile -> an aggregate proof over a sidecar of blobs, validated. Uses
the insecure testing setup unless a ceremony JSON path is given.

Usage: python examples/eth_blob_demo_torch.py [width] [setup.json]
           [--blobs N] [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from kzg_tpu_torch import eth  # noqa: E402


def run(width=4096, setup_path=None, n_blobs=2, device="cuda",
        verbose=True):
    def log(*a):
        if verbose:
            print(*a, flush=True)

    t0 = time.time()
    if setup_path:
        es = eth.EthSettings.from_json(setup_path, device=device)
    else:
        es = eth.EthSettings.insecure(424242424242, width, device=device)
    log(f"settings ready (width {es.width}, {es.device})",
        round(time.time() - t0, 1))

    rng = np.random.default_rng(99)

    def rand_blob():
        vals = rng.integers(0, 2**62, size=es.width, dtype=np.uint64)
        return b"".join(int(v).to_bytes(32, "little") for v in vals)

    blob = rand_blob()
    comm = eth.blob_to_kzg_commitment(es, blob)
    assert comm is not None
    log("commitment", comm.hex()[:24], round(time.time() - t0, 1))

    p = eth.blob_to_polynomial(es, blob)
    z = 31415926535897932384
    y = eth.evaluate_polynomial_in_evaluation_form(es, p, z)
    proof = eth.compute_kzg_proof(es, p, z)
    z32, y32 = z.to_bytes(32, "little"), y.to_bytes(32, "little")
    assert eth.verify_kzg_proof(es, comm, z32, y32, proof)
    log("point-evaluation proof verified", round(time.time() - t0, 1))

    vh = eth.kzg_to_versioned_hash(comm)
    out = eth.point_evaluation_precompile(es, vh + z32 + y32 + comm + proof)
    assert int.from_bytes(out[:32], "big") == es.width
    log("precompile ok", round(time.time() - t0, 1))

    blobs = [blob] + [rand_blob() for _ in range(n_blobs - 1)]
    comms = [comm] + [eth.blob_to_kzg_commitment(es, b) for b in blobs[1:]]
    agg = eth.compute_aggregate_kzg_proof(es, blobs)
    sidecar = eth.BlobsSidecar(b"\x22" * 32, 7, blobs, agg)
    eth.validate_blobs_sidecar(es, 7, b"\x22" * 32, comms, sidecar)
    log(f"aggregate proof over {n_blobs} blobs verified",
        round(time.time() - t0, 1))
    return True


def main(argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    n_blobs = int(argv[argv.index("--blobs") + 1]) if "--blobs" in argv \
        else 2
    rest = [a for i, a in enumerate(argv) if not a.startswith("--")
            and (i == 0 or argv[i - 1] not in ("--device", "--blobs"))]
    width = int(rest[0]) if rest else 4096
    path = rest[1] if len(rest) > 1 else None
    run(width, path, n_blobs, device)
    print("ETH BLOB DEMO PASS")


if __name__ == "__main__":
    main(sys.argv[1:])
