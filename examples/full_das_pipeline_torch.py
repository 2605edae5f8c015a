"""The full DAS pipeline on kzg_tpu_torch, at the PeerDAS shape by default
(a 4096-element blob extended to 8192, cells of 64), on the card.

The flow of the reference's TestFullDAS (integration_test.go:68-159):
random bytes -> 31-byte Fr packing -> reverse-bit order -> DAS extension
-> KZG commitment -> FK20 coset proofs -> every cell checked in one
batched pairing check on the card, and a few on the host pairing -> up to
half the cells dropped -> recovery -> the bytes back, exactly.

Usage: python examples/full_das_pipeline_torch.py [scale] [coset_width]
           [n_checks] [--device cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from kzg_tpu_torch.curve.weierstrass import map_points  # noqa: E402
from kzg_tpu_torch.das import recover_poly_from_samples  # noqa: E402
from kzg_tpu_torch.field import fr  # noqa: E402
from kzg_tpu_torch.fk20 import FK20MultiSettings  # noqa: E402
from kzg_tpu_torch.fk20.toeplitz import take_points  # noqa: E402
from kzg_tpu_torch.kzg import insecure_kzg_settings_device  # noqa: E402
from kzg_tpu_torch.ntt import (  # noqa: E402
    FFTSettings,
    bit_reversal_indices,
    das_extend_interleaved,
    fft,
    reverse_bit_order,
    reverse_bits_limited,
)

SECRET = 1927409816240961209460912649124


def run(scale=12, coset_width=64, n_checks=2, seed=1234, device="cuda",
        verbose=True):
    def log(*a):
        if verbose:
            print(*a, flush=True)

    t0 = time.time()
    n = 1 << scale
    n2 = 2 * n
    rng = np.random.default_rng(seed)
    data = bytes(rng.integers(0, 256, size=n * 31, dtype=np.uint8))

    # ---- pack: 31 bytes a field element (always below r) ----
    padded = np.zeros((n, 32), dtype=np.uint8)
    padded[:, :31] = np.frombuffer(data, dtype=np.uint8).reshape(n, 31)
    evens, valid = fr.from_bytes32_batch(padded.tobytes(), device)
    assert valid.all()
    evens = reverse_bit_order(evens)  # (integration_test.go:34)

    # ---- extend ----
    fs = FFTSettings(scale + 1, device)
    extended = das_extend_interleaved(fs, evens)  # (2n,)
    log(f"extended {n} -> {n2} elements", round(time.time() - t0, 1))

    # ---- commitment over the extension's coefficients (top half 0) ----
    ks = insecure_kzg_settings_device(SECRET, n, fs,
                                      g2_indices=(1, coset_width))
    coeffs = fft(fs, extended, inverse=True)
    commit = ks.commit_to_poly(coeffs[:n])
    log("committed", round(time.time() - t0, 1))

    # ---- FK20 coset proofs ----
    fk = FK20MultiSettings(ks, n2, coset_width)
    proofs = fk.fk20_multi_da_optimized(coeffs)
    cells = n2 // coset_width
    log(f"{cells} coset proofs", round(time.time() - t0, 1))

    # ---- the cells in the data's order, each with its coset ----
    ext_orig = reverse_bit_order(extended)
    stride = fs.max_width // n2
    roots = fs.roots_of_unity_int()
    dpos = [reverse_bits_limited(cells, i) for i in range(cells)]
    xs = [roots[d * stride] for d in dpos]
    brp_l = bit_reversal_indices(coset_width)
    ys = ext_orig.reshape(cells, coset_width, fr.N_WORDS)[:, brp_l]
    cell_proofs = take_points(proofs, dpos)

    # ---- verify: every cell on the card, a few on the host pairing ----
    tv = time.time()
    ok = ks.check_proof_multi_batch(commit, cell_proofs, xs, ys)
    assert all(ok), f"{ok.count(False)} cells failed verification"
    log(f"verified all {cells} cells in one batched check "
        f"({time.time() - tv:.3f} s)", round(time.time() - t0, 1))
    for i in rng.choice(cells, size=min(n_checks, cells), replace=False):
        i = int(i)
        assert ks.check_proof_multi(
            commit, map_points(lambda c: c[i], cell_proofs), xs[i], ys[i]), \
            f"cell {i} failed the host check"
    log(f"checked {min(n_checks, cells)} cells on the host pairing",
        round(time.time() - t0, 1))

    # ---- drop up to half the cells, recover ----
    dropped = []
    for i in range(cells):
        if rng.integers(0, 2) == 0 and len(dropped) < cells // 2:
            dropped.append(i)
    missing_elems = [e for i in dropped
                     for e in range(i * coset_width, (i + 1) * coset_width)]
    # cells are in the data's order; recovery runs in the polynomial's
    inv_brp = np.argsort(bit_reversal_indices(n2))
    missing = sorted(int(inv_brp[e]) for e in missing_elems)
    partial = reverse_bit_order(ext_orig).clone()
    partial[missing] = 0
    recovered = recover_poly_from_samples(fs, partial, missing)
    log(f"recovered {len(missing)} elements ({len(dropped)} cells)",
        round(time.time() - t0, 1))

    # ---- compare and unpack ----
    rec_orig = reverse_bit_order(recovered)
    assert bool(fr.eq(rec_orig, ext_orig).all()), "recovery mismatch"
    rec_bytes = fr.to_bytes32_batch(rec_orig[:n])[:, :31].tobytes()
    assert rec_bytes == data, "reconstructed bytes differ"
    log("byte-exact reconstruction OK", round(time.time() - t0, 1))
    return True


def main(argv):
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    args = [int(a) for i, a in enumerate(argv) if not a.startswith("--")
            and (i == 0 or argv[i - 1] != "--device")]
    run(*args[:3], device=device)
    print("FULL DAS PIPELINE PASS")


if __name__ == "__main__":
    main(sys.argv[1:])
