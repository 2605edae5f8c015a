#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (kzg_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero with no result:
  1. build every CUDA kernel from kzg_tpu_torch/csrc (one nvcc per source,
     in parallel), print each kernel's registers, stack frame and spill
     bytes from ptxas, and the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card, bit
     for bit, at the main path's shapes (`butterfly`, on no path, at 2^16,
     2^16 - 3 and 2^20 Fr and Fp lanes, per-lane and with one broadcast
     twiddle, and on a few lanes against Python ints; the digit recoding
     fr_signed_windows at part 2's 8192 scalars and at 9 x 4096, from
     Montgomery words, the ends of the range included, and
     fr.scalar_windows_signed in one launch of it;
     the G1 FFT stage at 16 points, dense and 4 x 4, and at 128 points
     dense, and at 16 points summing to zero (an output at infinity), and K4 under a forced radix-2 plan at 128, whose transform
     must equal the dense one in affine form; the window tables and the
     fixed-base product at 2^10 lanes, and with two lanes a base, and at
     the path's 8192 in 4; g1_sum at the path shapes, FK20's 64-way sum
     of 128 rows, the commitment's 4096 lanes and the MSM's 64 windows of
     4096 points, and on edge rows (one point, odd counts, a row all at
     infinity in both encodings, P with -P, P with P); g1_horner for one
     and three MSMs; K2 on its per-stage route (the port's earlier Fr
     FFT, kept here) at 2^12; the field routes: fr_add_sub (Fr and Fp, add,
     sub, neg, both broadcast forms), fr_pow (Fr at 8192 lanes with
     r-2, 0, 1 and a random exponent, Fp with p-2), fr_batch_inv (8192
     lanes in one launch, 2^16 in three, zero lanes mixed in),
     fr_fft_block (the product tree's batches 32 x 256 ... 1 x 8192 and
     FK20's 64 x 128, forward and inverse, also against K2's route, in
     at most 2 launches; 8192 in 4-stage tiles), fr_zero_poly_leaves
     (64 full leaves; full, partial and padding leaves) and fr_das_block
     (the DAS extension of 1 x 4096 and of a block's 9 blobs, odds and
     interleaved, in 3 launches, also against the per-level route on
     fr_dif_stage, K2 and fr_scale));
  3. Fr FFT at 2^20 on fr_fft_block (at most 3 launches): forward then
     inverse, the roundtrip, a few outputs against direct evaluation
     with Python ints, and the forward against K2's per-stage route;
  4. the proof path at the PeerDAS shape (EIP-7594: a 4096-element blob
     extended to 8192, 64-element cells, 128 cell proofs): device CRS of
     4096 points, FK20MultiSettings(n2=8192, l=64) with its fixed-base
     tables (built and counted as the setup path), blob -> coefficients
     (inverse FFT) -> da_using_fk20_multi. The launch counters of its
     kernels must be > 0 and K1's (mont_mul) 0; the 128 proofs must
     equal the same call on the plain path on the card and an exact host
     oracle ([q(s)]G for the
     known secret). The plain path rebuilds the settings' 64-window
     tables on the plain version and they must equal the kernel's; part
     2's fixed-base product at the path's 8192 lanes must equal its plain
     version bit for bit and K3's in affine form. The CRS's fixed-base
     tables (built with the setup, counted there) must equal their plain
     rebuild. The path must launch g1_sum once and g1_add never;
  5. the producer path at the same shape (a blob builder's flow,
     examples/full_das_pipeline.py:49-78): 4096 evaluations ->
     das_extend_interleaved (fr_das_block) -> 8192 values -> inverse FFT
     (top half zero) -> commit_to_poly (a 4096-point MSM: one fixed-base
     product on the CRS tables and one g1_sum) -> fk20_multi_da_optimized.
     The launch counters of its kernels must be > 0, and g1_double's,
     mont_mul's, fr_dif_stage's, fr_butterfly_stage's and fr_scale's 0;
     the extension must equal the plain path's, the commitment the host oracle [p(s)]G,
     the variable-base lin_comb_g1 and the plain route on the plain CRS
     tables, the proofs the host oracle;
  6. the reconstruction path at the same shape (a PeerDAS node that holds
     64 of the 128 cells, consensus-specs recover_cells_and_kzg_proofs):
     the producer's extension with the other 64 cells' 4096 values
     garbled -> recover_poly_from_samples -> inverse FFT (top half zero)
     -> commit_to_poly -> fk20_multi_da_optimized. The launch counters
     of the path's kernels must be > 0 and g1_double's and
     fr_butterfly_stage's 0; the values must equal the extension, the
     commitment and the 128 proofs the producer's. The recovery alone,
     counted: no fr_butterfly_stage, fewer than 150 mont_mul launches and
     at most 2 log2 n + 2 of one lane (no Fermat ladder); an 8192-point
     FFT in at most 2 launches. At n = 1024 with half missing, the legacy
     erasure_code_recover must equal recover_poly_from_samples;
  7. the proof API at full width, its launches counted as a path (it
     must launch fr_add_sub and fr_pow): compute_proof_single on the
     blob's 4096 coefficients ("auto" and "serial" against the host
     oracle), compute_proof_multi for one cell's coset against that
     cell's FK20 proof, and FK20SingleSettings on an 8192-point CRS with
     da_using_fk20 (8192 proofs, its launches counted as a path), eight
     of them against the host oracle;
  8. the verification path at the same shape (a DAS consumer checking a
     blob's 128 cells, kzg_tpu/kzg/settings.py:189-225): the producer's
     commitment and 128 proofs compressed to 48-byte points and
     decompressed on the card (decompress_g1_batch: the square roots on
     fr_pow, the subgroup check on K3), which must give the points sent;
     one check_proof_multi_batch over all 128 cells (in the bilinear form
     e(I - C - [x^l]pi, G2) e(pi, [s^l]_2) == 1; cell j: the coset
     w^j <w_64>, its values in the coset's natural order) must be all
     True, its launches counted as a path (K3 at least once, the lines of
     G2 and [s^l]_2 once, K-b's evaluation and K-c once each, K-a never,
     fr_add_sub at most twice: no G2 sub), and a second call must not
     recompute the cached lines; with cell 7 given cell 8's proof and one
     value of cell 100 changed, exactly cells 7 and 100 False, and
     check_proof_multi on the host pairing for four cells agreeing; K-a
     (g2_scalar_mul, on no path), K-b's lines (pairing_lines) and
     evaluation (pairing_miller_eval) and K-c (pairing_final_exp) against
     their plain versions bit for bit: the lines of G2 and [s^64]_2 and
     of 5 points of their own lanes (one the encoding of infinity); the
     path's first 5 lanes with a G2 point at infinity (K-a), pi at
     infinity, a1 at infinity, [s^l]_2 flagged at infinity and both in one
     lane (K-b on the fixed lines and on the lanes' own, and K-c on their
     Miller values);
  9. times on the card after warm-up: whole calls with CUDA events,
     each kernel's device time (its output first held bit for bit against
     its plain version at the timed shape; the plain version's time is
     that one run's, with no warm-up), the old routes beside the new
     ones in turns (K3 and K4 against the fixed-base product and the dense
     stage; the previous commit route, window sums on a g1_add tree and a
     Horner loop of 315 one-lane launches, against the fixed-base commit;
     FK20's 6-launch g1_add tree against g1_sum), the variable-base MSM at
     4096 points, the 8192-point G1 FFT under several radix plans with
     each stage's time, the Fp product's dependent latency (a one-lane
     K3 launch) and the Fr product's (a one-lane fr_pow ladder), the
     FK20, commit and recovery calls' device activity from torch.profiler
     traces (the recovery's at most 400 device operations), and the
     routes of K1 and K2 beside the new kernels in turns: K2's per-stage
     FFT against fr_fft_block at 1 x 8192 and 2^20, the one-lane ladder
     of K1 launches against fr_pow, the batch inversion on K1 scans
     against fr_batch_inv, the 64-step leaf loop against fr_zero_poly_leaves;
     the DAS extension's trace (at most 3 device operations) and, in
     turns at 1 and 9 blobs, the per-level route against fr_das_block,
     and the producer path on the per-level extension route against it
     on fr_das_block; fr_signed_windows' and butterfly's rows at each of
     their shapes; the batched check of 128 cells (ms, ms a cell, and its
     trace) and the rows of K3 and K-a, K-b's lines (the two fixed G2
     points), K-b's evaluation and K-c at its 128 lanes, a warp a lane,
     each with its bound and its latency bound (the longest thread's
     chain of Fp product latencies on this run's data times the product's
     measured latency);
 10. the EIP-4844 API at its width (4096 field elements a blob, a
     sidecar of 6 blobs, Deneb's MAX_BLOBS_PER_BLOCK), its launches
     counted as two paths (eth_setup, eth): EthSettings.insecure (one K3
     launch), the Lagrange tables, blob -> commitment, evaluation,
     compute_kzg_proof, verify_kzg_proof, the precompile,
     compute_aggregate_kzg_proof and validate_blobs_sidecar. The
     commitments must equal [p(s)]G with p(s) by the barycentric formula
     on Python ints, y the host value, the proof [(p(s) - y)/(s - z)]G,
     the aggregate proof its oracle over the host transcript; a tampered
     y, proof, sidecar and blob are rejected; g1_horner,
     g1_fixed_base_mul and g1_sum (and the rest of ETH_KERNELS) must
     launch; the same calls at width 256 must give the plain path's
     bytes; from_json of a file written from the setup must give its
     points. Wall ms of each call, the aggregate proof's trace;
 11. the generic G1 FFT (fft_g1(..., in_subgroup=False), K3 and g1_add):
     16 points off the r-torsion both ways against the host's radix-2
     butterflies on the same twiddles (off the r-torsion the transform
     is no DFT over Fr: [a]P depends on a mod ord(P)); at 128 and 4096
     subgroup points equal to the GLV route; inverse(forward) at 4096
     subgroup points the identity; one forward at 4096 launches K3 and
     g1_add 12 times each and no GLV kernel; its ms beside the GLV
     route's;
 12. persistence at the PeerDAS shape: the KZG settings and
     FK20MultiSettings(n2=8192, l=64) saved and loaded; the loaded
     settings' 128 proofs must equal the ones before; file bytes, save
     and load seconds;
 13. examples/eth_blob_demo_torch.py and full_das_pipeline_torch.py at
     their defaults, each in its own process, ending in its PASS line;
 14. the sharded paths (kzg_tpu_torch.parallel) at D = 2 and D = 4 ranks,
     each rank a process (kzg_tpu_torch/tools/sharded_check.py) joined
     through a file store: NCCL with a card a rank where the machine has
     D cards, else gloo with every rank on this card and the collectives
     staged through host memory. At the PeerDAS shape the gathered
     result of every path must equal the single-device path on the same
     card (Fr words, points in affine form): the Fr FFT at 2^20 both
     ways, the G1 FFT at 128 and 4096 points both ways, the
     reverse-bit-order shuffle at 128, the MSM at 4096 points and
     da_using_fk20_multi_sharded (128 proofs); each path's kernels must
     launch on some rank. One line a D: the transport, ms a call on rank
     0 and its share in collectives, rank 0's launches;
 15. the field-chain experiments (kzg_tpu_torch/experiments, on
     csrc/exp_field_kernels.cu; on no path of the library): the SASS of
     X1-C's and X2's kernels must hold IMMA.16832.U8.U8 (mma.sync u8 x u8
     -> s32) and the other kernels' none; the three entry points at the
     scripts' shapes, their launches counted as a path (exp_field), every
     line correct, each case launched (X1 exp_mont_chain: A, B, C for Fr
     and Fp, 256-deep at 2048 lanes; X2 exp_tc_mont_mul: the hybrid
     product, the pass on the tensor cores and on the CUDA cores at 2048,
     16384 and 131072 Fp lanes, beside K1; X12 exp_op_chain: six small Fp
     ops, 256-deep at 2048 lanes); each case bit for bit against its
     plain version and on a few lanes against Python ints, its device
     time a launch from a trace, its bound (bytes, 32-bit word operations,
     u8 tensor-core multiply-adds) and its latency bound (the depth times
     one warp's dependent step, timed at depths 256 and 4096); K1's
     device time beside the hybrid's for the script's 1.3x decision; and
     torch._int_mm on signed byte digits, the q pass's column sums at
     131072 lanes, as X2's library_ms;
 16. the product-body experiments (kzg_tpu_torch/experiments, on
     csrc/exp_field_kernels.cu; on no path of the library): the four
     entry points at the scripts' shapes, their launches counted as a
     path (exp_chain), every line correct, each case launched (X4
     exp_ab_mul and X5 exp_carry: exp_tuple_chain's 7-product body, 64
     deep at 2048 lanes, on mont12, lazy12, lazy13 and lazy16 and with its
     carry in registers, in shared memory or serial; X6 exp_truth and X11
     exp_addcost: exp_ext_chain's 8-product body in the 13-word lazy
     domain on 2048 points, with 0, 4 or 12 extra adds, 12 subs or 12 raw
     adds, 64 deep, X6 also 512); every case bit for bit against its plain
     version at depth 8 and at the timed depth on all 2048 lanes (512: on
     4 lanes), and on a few lanes against a Python-int model; subs1, a
     check-only case of one lazy sub (subs12's words are all 0), the
     same way; fold12's words equal to adds12's; the new kernels' ptxas
     registers, stack and spills and their SASS instructions; each case's
     device time a launch from a trace, its bound (each product's needed
     multiply-adds on the chain's operand widths) and its latency bound
     (the body's critical path times one warp's dependent product at
     that width, timed on the serial body at depths 64 and 512, and
     X12's carry chain for an extra op); the ns an extra op costs beside
     adds0's body, from the traces; the warp probe (tuple3 and serial
     on mont12 with 1 and 2 warps on each SM sub-partition);
 17. the point-op experiments (kzg_tpu_torch/experiments, on
     csrc/exp_point_kernels.cu and csrc/exp_field_kernels.cu; on no path
     of the library): the five entry points at the scripts' shapes, their
     launches counted as a path (exp_point), every line correct, each
     case launched (X3 exp_calib: mont24, lazy25, the lazy double chain
     and K4's GLV butterfly in one process; X7 exp_bisect: the lazy
     7-product body as base (phase 16's lazy13 launch), transp, ctx and
     conv; X8 exp_width: serial8 at 256 threads a block, the lazy and the
     ladder double at 64, 256, 512 and 1024, K4 at its 64; X9
     exp_pointops: the Jacobian double, add and window step, mul and sqr
     chains; X10 exp_lazyops: the lazy double, add and window step beside
     the ladder domain's, the mulref chains); every exp_point_chain case,
     the new exp_tuple_chain bodies and the exp_ext_body bodies bit for
     bit against their plain versions at depth 8 on all 2048 lanes, and
     at 64 on a few lanes against Python-int models; the ladder's words
     equal to the lazy domain's; ptxas registers, stack and spills and the
     SASS instructions of every new instantiation, and g1_add's,
     g1_double's, tuple_chain_kernel's and ext_chain_kernel's registers
     as they were before lazy.cuh and g1_jac.cuh took their code; each
     case's device time from a trace, its bound and its latency bound
     (the chain's critical path in dependent products on lane 0's data
     times phase 16's dependent product); X8's SM-ns a lane-op by threads
     a block and X3's ratios to mont24.
The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Needs no network and
imports nothing of JAX or kzg_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20240
SECRET = 1927409816240961209460912649124
# published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s, and
# the CUDA-core float32 rate, used as the rate of 32-bit integer
# multiply-adds (2 operations each, like an FMA)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# and the dense int8 tensor-core rate, for mma.sync u8 x u8 -> s32
PEAK_TC_OPS = 1979e12
OUT_DIR = "chiprun_out"
# the kernels every FK20 multi call runs (the blob's inverse FFT and the
# Toeplitz coefficients' FFTs on fr_fft_block, part 2's digits and
# fixed-base product, the l-way sum, the dense G1 FFTs); K1 (mont_mul) it
# must launch no time: the recoding reduces Montgomery words itself
PATH_KERNELS = ("fr_fft_block", "fr_signed_windows", "g1_fixed_base_mul",
                "g1_window_table", "g1_fft_stage", "g1_sum")
# and the DAS extension's (the producer path)
EXTENSION_KERNELS = ("fr_das_block",)
# and the per-level route that fr_das_block replaced, which the producer
# path must launch no more
STAGE_DAS_KERNELS = ("fr_dif_stage", "fr_butterfly_stage", "fr_scale")
# and the recovery's (the reconstruction path)
RECOVERY_KERNELS = ("fr_zero_poly_leaves", "fr_batch_inv")
# and the batched sample check's (the verification path, in its bilinear
# form): the coset inverse FFTs, x^-1 and x^l, the interpolation
# commitments, [x^l]pi (K3), a1 = I - C - [x^l]pi, the lines of G2 and
# [s^l]_2 (K-b's lines part, once a settings object), K-b's evaluation
# and the final exponentiation (K-c)
VERIFY_KERNELS = ("fr_fft_block", "fr_batch_inv", "fr_pow",
                  "fr_signed_windows", "g1_fixed_base_mul", "g1_sum",
                  "g1_add", "g1_scalar_mul", "pairing_lines",
                  "pairing_miller_eval", "pairing_final_exp")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """fn's output and the time of that one call (CUDA events, no
    warm-up): the plain versions, which run for seconds, once a row."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


# spin launches before and after every traced call: torch.profiler drops
# the device records that fall outside its window as it places them, and
# that placement drifts from the launches' true times the older the
# process is, by an amount that differs between processes
# (kzg_tpu_torch/tools/trace_loss.py counts the records lost; on an H100
# the loss reached whole 10 ms calls about 300 s into a run), so each
# side carries TRACE_BALLAST launches of about 0.5 ms each, and a trace
# counts only when some of both sides survive
TRACE_BALLAST = 100
BALLAST_CYCLES = 1_000_000
TRACE_TRIES = 3


def device_events(fn, chrome_dir=None) -> list:
    """(name, start_us, end_us) of every device activity (kernels, copies)
    of one call of fn, from torch.profiler's CUPTI trace (written as a
    Chrome trace into chrome_dir where given). A trace counts only when
    it kept some of the ballast on both sides of the call, so that it
    holds every record of the call; up to TRACE_TRIES calls are traced
    for one that does, else the script fails."""
    import torch
    from torch.autograd import DeviceType

    from kzg_tpu_torch.utils import profiling

    def ballast():
        for _ in range(TRACE_BALLAST):
            torch.cuda._sleep(BALLAST_CYCLES)
        torch.cuda.synchronize()

    for attempt in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profiling.trace(chrome_dir) as prof:
            ballast()
            fn()
            torch.cuda.synchronize()
            ballast()
        ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda t: t[1])
        spin = ["spin_kernel" in name for name, _, _ in ev]
        mine = [i for i, is_spin in enumerate(spin) if not is_spin]
        check(bool(mine), "a trace caught no device operation of its call")
        before, after = sum(spin[:mine[0]]), sum(spin[mine[-1] + 1:])
        if before and after:
            return [ev[i] for i in mine]
        log(f"    (a trace kept {before} and {after} of its {TRACE_BALLAST} "
            f"ballast launches before and after the call, try "
            f"{attempt + 1} of {TRACE_TRIES})")
    check(False, "a trace lost device records past its ballast")


def kernel_ms(fn, match: str, reps: int):
    """(mean device ms of one launch of the kernel whose name holds
    `match`, launches the trace caught). fn launches it once a call."""
    fn()
    spans = device_events(lambda: [fn() for _ in range(reps)])
    mine = [e - s for name, s, e in spans if match in name]
    check(bool(mine), f"the trace caught no launch of {match}")
    return sum(mine) / 1e3 / len(mine), len(mine)


def busy_us(spans) -> float:
    """Length of the union of the device activity intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(spans, key=lambda t: t[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def bound_ms(nbytes: float, word_products: float, tc_macs: float = 0.0):
    """Least time for the work: bytes at HBM rate vs 32x32->64 word
    products (one multiply-add, 2 operations each) at the peak rate and
    u8 tensor-core multiply-adds (2 operations each) at the dense int8
    rate; the largest."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = max(2 * word_products / PEAK_OPS, 2 * tc_macs / PEAK_TC_OPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def random_fr_ints(rng, n: int, modulus: int) -> list:
    w = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64).tolist()
    return [(a + (b << 63) + (c << 126) + (d << 189) + (e << 252)) % modulus
            for a, b, c, d, e in w]


def eval_poly(coeffs, x: int, m: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % m
    return acc


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def oracle_proofs(coeffs, n2: int, l: int, secret: int, r: int, host_ec):
    """Coset proofs of DAUsingFK20Multi by definition: proof j is
    [q(s)]G with q = f div (X^l - x0^l), x0 the coset's first point in
    reverse-bit order."""
    n = len(coeffs)
    k2 = n2 // l
    bits = (k2 - 1).bit_length()
    w = pow(7, (r - 1) // n2, r)
    s = secret % r
    g = host_ec.g1_generator()
    out = []
    for j in range(k2):
        c = pow(pow(w, bitrev(j, bits), r), l, r)
        q = [0] * n
        for i in range(n - 1 - l, -1, -1):
            q[i] = (coeffs[i + l] + c * (q[i + l] if i + l < n else 0)) % r
        out.append(host_ec.g1_mul(g, eval_poly(q, s, r)))
    return out


@contextlib.contextmanager
def plain_path():
    """Route the modules' kernel calls to the plain versions (this
    script's reference run; the package itself never does this)."""
    from kzg_tpu_torch.curve import fft_g1, g1, msm
    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.das import zero_poly
    from kzg_tpu_torch.field import fp, fr
    from kzg_tpu_torch.field import kernels as fk
    from kzg_tpu_torch.fk20 import multi, toeplitz
    from kzg_tpu_torch.ntt import das, fft_fr

    swaps = [(fr, "mont_mul", fk.mont_mul_plain),
             (fr, "fr_signed_windows", fk.fr_signed_windows_plain),
             (fr, "fr_add_sub", fk.fr_add_sub_plain),
             (fr, "fr_pow", fk.fr_pow_plain),
             (fr, "fr_batch_inv", fk.fr_batch_inv_plain),
             (fp, "mont_mul", fk.mont_mul_plain),
             (fp, "fr_add_sub", fk.fr_add_sub_plain),
             (fp, "fr_pow", fk.fr_pow_plain),
             (fft_fr, "fr_fft_block", fk.fr_fft_block_plain),
             (zero_poly, "fr_zero_poly_leaves",
              fk.fr_zero_poly_leaves_plain),
             (das, "fr_das_block", fk.fr_das_block_plain),
             (g1, "g1_scalar_mul", gk.g1_scalar_mul_plain),
             (g1, "g1_add", gk.g1_add_plain),
             (g1, "g1_double", gk.g1_double_plain),
             (fft_g1, "g1_glv_butterfly", gk.g1_glv_butterfly_plain),
             (fft_g1, "g1_window_table", gk.g1_window_table_plain),
             (fft_g1, "g1_fft_stage", gk.g1_fft_stage_plain),
             (msm, "g1_window_table", gk.g1_window_table_plain),
             (toeplitz, "g1_fixed_base_mul", gk.g1_fixed_base_mul_plain),
             (msm, "g1_fixed_base_mul", gk.g1_fixed_base_mul_plain),
             (msm, "g1_sum", gk.g1_sum_plain),
             (msm, "g1_horner", gk.g1_horner_plain),
             (multi, "g1_sum", gk.g1_sum_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def symbol(mangled: str) -> str:
    """The qualified name in an Itanium-mangled symbol with its template
    arguments of literal values (ints, bools), without the function
    arguments: enough to tell ptxas's functions apart."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    parts = []
    while s[:1].isdigit():
        k = len(s) - len(s.lstrip("0123456789"))
        n = int(s[:k])
        parts.append(s[k:k + n])
        s = s[k + n:]
    name = "::".join(p for p in parts
                     if not p.startswith(("_GLOBAL__N", "_INTERNAL")))
    if s.startswith("I") and name:
        args, s = [], s[1:]
        while s.startswith("L") and "E" in s:
            kind, value, s = s[1], s[2:s.index("E")], s[s.index("E") + 1:]
            args.append({"b1": "true", "b0": "false"}.get(kind + value,
                                                          value))
        name += f"<{', '.join(args)}>"
    return name or mangled


def ptxas_report(lib: str, text: str) -> dict:
    """{"lib:function": registers, stack frame and spill bytes} from the
    -Xptxas -v log of one library."""
    import re

    out, fn = {}, None
    for line in text.splitlines():
        if "Function properties for" in line:
            fn = f"{lib}:{symbol(line.split()[-1])}"
            out.setdefault(fn, {"registers": None, "stack_frame": 0,
                                "spill_stores": 0, "spill_loads": 0})
        elif fn and "stack frame" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            out[fn].update(zip(("stack_frame", "spill_stores",
                                "spill_loads"), nums))
        elif fn and "registers" in line:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
    return out


def check(ok: bool, what: str) -> None:
    """Fail the run (not an assert: the checks must hold under -O too)."""
    if not ok:
        raise RuntimeError(what)


def same(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> int:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


ETH_SECRET = 424242424242
# Deneb's MAX_BLOBS_PER_BLOCK: the sidecar of the aggregate proof
SIDECAR_BLOBS = 6
# the width of the eth calls held against the plain path
ETH_PLAIN_WIDTH = 256
# the generic G1 FFT: points off the subgroup against the host, and the
# sizes of subgroup points against the GLV route (the last one timed)
GENERIC_OFF_POINTS = 16
GENERIC_SIZES = (128, 4096)
# the eth path's kernels: the insecure setup's K3, the Lagrange tables
# (g1_window_table), the commitments and the quotient's commitment
# (fr_signed_windows, g1_fixed_base_mul, g1_sum), the evaluation and the
# quotient (fr_add_sub, mont_mul, fr_batch_inv, fr_pow), the aggregated
# commitment over the decompressed commitments (lin_comb_g1: g1_add,
# g1_sum, g1_horner)
ETH_KERNELS = ("fr_signed_windows", "g1_fixed_base_mul", "g1_sum",
               "g1_horner", "g1_add", "fr_add_sub", "mont_mul",
               "fr_batch_inv", "fr_pow")


def slope_ms(fn, *args) -> float:
    """ms a call of fn(*args), as utils.benchloop.device_loop's slope
    between 1 and 9 calls: on CUDA events where args hold a CUDA tensor,
    else on the host's clock (an eth call ends by reading its result to
    the host, so the host clock holds the whole of it)."""
    from kzg_tpu_torch.utils.benchloop import device_loop

    per_op, _, floored = device_loop(fn, args, k=8, windows=2)
    if floored:
        log("    (this slope did not clear the spread of its tries)")
    return per_op * 1e3


def host_eval(evals, domain, x: int, r: int) -> int:
    """p(x) of a polynomial in evaluation form on `domain` (Python ints):
    the barycentric formula (x^n - 1)/n sum_i e_i w_i / (x - w_i), or the
    stored value where x lies on the domain."""
    if x % r in domain:
        return evals[domain.index(x % r)]
    n = len(domain)
    acc = 0
    for e, w in zip(evals, domain):
        acc += e * w * pow(x - w, -1, r)
    return acc * (pow(x, n, r) - 1) * pow(n, -1, r) % r


def counted(*mods) -> dict:
    out = {}
    for m in mods:
        out.update(m.LAUNCHES)
    return out


def eth_phase(dev, card, rng, kmods, plain_path, trace):
    """The EIP-4844 API at its width (4096 field elements a blob): the
    insecure setup, blob -> commitment, evaluation, proof, verification,
    the precompile, the aggregate proof over a 6-blob sidecar and its
    validation, each against a host oracle; tampered inputs rejected; the
    same calls on the plain path at width 256; from_json on a file written
    from the setup. Returns (results, setup launches, path launches)."""
    import tempfile

    import torch

    from kzg_tpu_torch import eth
    from kzg_tpu_torch.curve import serialization
    from kzg_tpu_torch.field import fr
    from kzg_tpu_torch.ntt import bit_reversal_indices
    from kzg_tpu_torch.utils import host_ec

    r = fr.SPEC.modulus
    width = eth.FIELD_ELEMENTS_PER_BLOB
    for m in kmods:
        m.reset_launches()
    t = time.time()
    es = eth.EthSettings.insecure(ETH_SECRET, width, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t = time.time()
    tables = es.lagrange_tables
    torch.cuda.synchronize()
    table_s = time.time() - t
    table_bytes = tables.numel() * tables.element_size()
    table_peak = torch.cuda.max_memory_allocated() - mem0
    setup_launches = counted(*kmods)
    check(setup_launches["g1_scalar_mul"] == 1,
          "the insecure eth setup is not one K3 launch")
    check(setup_launches["g1_window_table"] > 0,
          "the Lagrange tables did not launch g1_window_table")
    gen = host_ec.g1_generator()
    s = ETH_SECRET % r
    # [L_i(s)]G of a few points against the host: L_i(s) with w_i the
    # bit-reversed domain's i-th point
    sw = pow(s, width, r)
    for i in (0, 1, width - 1):
        w = es.domain_ints[i]
        li = w * (sw - 1) * pow(width * (s - w), -1, r) % r
        check(es.lagrange_affine_brp[i] == host_ec.g1_mul(gen, li),
              f"Lagrange point {i} differs from the host")
    check(es.setup_g1_affine[5] == host_ec.g1_mul(gen, pow(s, 5, r)),
          "setup_g1[5] differs from the host")

    def blob_of(ints):
        return b"".join(v.to_bytes(32, "little") for v in ints)

    ints = [random_fr_ints(rng, width, r) for _ in range(SIDECAR_BLOBS)]
    blobs = [blob_of(v) for v in ints]
    z = random_fr_ints(rng, 1, r)[0]
    z32 = z.to_bytes(32, "little")

    def commitment_oracle(ev):
        return serialization.compress_g1(host_ec.g1_mul(
            gen, host_eval(ev, es.domain_ints, s, r)))

    def proof_oracle(ev, x):
        y_ = host_eval(ev, es.domain_ints, x, r)
        ps = host_eval(ev, es.domain_ints, s, r)
        return y_, serialization.compress_g1(host_ec.g1_mul(
            gen, (ps - y_) * pow(s - x, -1, r) % r))

    for m in kmods:
        m.reset_launches()
    comm = eth.blob_to_kzg_commitment(es, blobs[0])
    p0 = eth.blob_to_polynomial(es, blobs[0])
    y = eth.evaluate_polynomial_in_evaluation_form(es, p0, z)
    proof = eth.compute_kzg_proof(es, p0, z)
    y32 = y.to_bytes(32, "little")
    ok = eth.verify_kzg_proof(es, comm, z32, y32, proof)
    vh = eth.kzg_to_versioned_hash(comm)
    pre = eth.point_evaluation_precompile(es, vh + z32 + y32 + comm + proof)
    comms = [comm] + [eth.blob_to_kzg_commitment(es, b) for b in blobs[1:]]
    agg = eth.compute_aggregate_kzg_proof(es, blobs)
    side = eth.BlobsSidecar(b"\x33" * 32, 9, blobs, agg)
    eth.validate_blobs_sidecar(es, 9, b"\x33" * 32, comms, side)
    torch.cuda.synchronize()
    path_launches = counted(*kmods)
    log(f"eth path launches: {json.dumps(path_launches)}")
    for name in ETH_KERNELS:
        check(path_launches[name] > 0,
              f"{name} was not launched on the eth path")
    check(ok, "verify_kzg_proof rejected a true proof")
    check(pre == width.to_bytes(32, "big") + r.to_bytes(32, "big"),
          "the precompile's output is wrong")
    # the host oracles
    check(comms == [commitment_oracle(v) for v in ints],
          "the commitments differ from the host oracle [p(s)]G")
    y_o, proof_o = proof_oracle(ints[0], z)
    check(y == y_o, "y differs from the host barycentric value")
    check(proof == proof_o, "the proof differs from [(p(s) - y)/(s - z)]G")
    h = hashlib.sha256(eth.FIAT_SHAMIR_PROTOCOL_DOMAIN
                       + width.to_bytes(8, "little")
                       + SIDECAR_BLOBS.to_bytes(8, "little")
                       + b"".join(blobs) + b"".join(comms)).digest()
    rr = int.from_bytes(hashlib.sha256(h + b"\x00").digest(), "little") % r
    chal = int.from_bytes(hashlib.sha256(h + b"\x01").digest(), "little") % r
    agg_ev = [sum(pow(rr, k, r) * ints[k][i] for k in range(SIDECAR_BLOBS))
              % r for i in range(width)]
    check(agg == proof_oracle(agg_ev, chal)[1],
          "the aggregate proof differs from its host oracle")
    # tampered inputs
    y1 = ((y + 1) % r).to_bytes(32, "little")
    check(not eth.verify_kzg_proof(es, comm, z32, y1, proof),
          "a tampered y was accepted")
    check(not eth.verify_kzg_proof(es, comm, z32, y32, comms[1]),
          "a tampered proof was accepted")
    bad = eth.BlobsSidecar(b"\x33" * 32, 9, blobs, proof)
    try:
        eth.validate_blobs_sidecar(es, 9, b"\x33" * 32, comms, bad)
        check(False, "a tampered sidecar was accepted")
    except ValueError:
        pass
    tampered = bytearray(blobs[-1])
    tampered[64] ^= 1
    check(not eth.verify_aggregate_kzg_proof(
        es, blobs[:-1] + [bytes(tampered)], comms, agg),
        "a tampered blob passed the aggregate check")
    log(f"eth at width {width}: setup {setup_s:.2f} s (one K3 launch), "
        f"Lagrange tables {table_s:.3f} s, {table_bytes} bytes, peak "
        f"{table_peak} bytes; the commitments, y, the proof and the "
        f"{SIDECAR_BLOBS}-blob aggregate proof equal their host oracles; "
        f"verify, precompile and the sidecar pass; tampered y, proof, "
        f"sidecar and blob are rejected")

    # the same calls on the plain path at width 256
    small = [blob_of(v[:ETH_PLAIN_WIDTH]) for v in ints]

    def small_run():
        es_ = eth.EthSettings.insecure(ETH_SECRET, ETH_PLAIN_WIDTH,
                                       device=dev)
        p_ = eth.blob_to_polynomial(es_, small[0])
        cs = [eth.blob_to_kzg_commitment(es_, b) for b in small]
        y_ = eth.evaluate_polynomial_in_evaluation_form(es_, p_, z)
        pf = eth.compute_kzg_proof(es_, p_, z)
        ag = eth.compute_aggregate_kzg_proof(es_, small)
        return (es_.lagrange_affine_brp, cs, y_, pf, ag,
                eth.compute_aggregated_poly_and_commitment(
                    es_, eth.blobs_to_polynomials(es_, small), cs)[1],
                eth.verify_aggregate_kzg_proof(es_, small, cs, ag))

    got = small_run()
    with plain_path():
        want = small_run()
    check(got == want, f"the eth calls at width {ETH_PLAIN_WIDTH} differ "
          "from the plain path")
    check(got[-1], f"the aggregate check failed at width {ETH_PLAIN_WIDTH}")

    # from_json on a file of the reference's schema written from the setup
    natural = [None] * width
    for i, j in enumerate(bit_reversal_indices(width)):
        natural[int(j)] = es.lagrange_affine_brp[i]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trusted_setup.json")
        with open(path, "w") as f:
            json.dump({"setup_G1": [serialization.g1_to_hex(p)
                                    for p in es.setup_g1_affine],
                       "setup_G2": [serialization.g2_to_hex(q) for q in
                                    (host_ec.g2_generator(), es.setup_g2_1)],
                       "setup_G1_lagrange": [serialization.g1_to_hex(p)
                                             for p in natural]}, f)
        t = time.time()
        loaded = eth.EthSettings.from_json(path, device=dev)
        from_json_s = time.time() - t
    check(loaded.lagrange_affine_brp == es.lagrange_affine_brp
          and loaded.setup_g1_affine == es.setup_g1_affine
          and loaded.setup_g2_1 == es.setup_g2_1,
          "from_json gives other points than the setup it was written from")
    log(f"eth: the calls at width {ETH_PLAIN_WIDTH} equal the plain path's; "
        f"from_json of "
        f"{2 * width} G1 points {from_json_s:.2f} s, the same points")

    times = {
        "commitment_ms": slope_ms(lambda: eth.blob_to_kzg_commitment(
            es, blobs[0])),
        "evaluation_ms": slope_ms(
            lambda: eth.evaluate_polynomial_in_evaluation_form(es, p0, z)),
        "proof_ms": slope_ms(lambda: eth.compute_kzg_proof(es, p0, z)),
        "verification_ms": slope_ms(lambda: eth.verify_kzg_proof(
            es, comm, z32, y32, proof)),
        "aggregate_proof_ms": slope_ms(
            lambda: eth.compute_aggregate_kzg_proof(es, blobs)),
        "validation_ms": slope_ms(lambda: eth.validate_blobs_sidecar(
            es, 9, b"\x33" * 32, comms, side)),
    }
    log(f"[{card}] eth at width {width}, ms a call (host clock, the slope "
        "of 1 to 9 calls): " + ", ".join(
        f"{k[:-3]} {v:.3f}" for k, v in times.items())
        + f" ({SIDECAR_BLOBS} blobs aggregate and validation)")
    prof = trace(f"eth compute_aggregate_kzg_proof ({SIDECAR_BLOBS} blobs)",
                 lambda: eth.compute_aggregate_kzg_proof(es, blobs),
                 times["aggregate_proof_ms"],
                 os.path.join(OUT_DIR, "eth_aggregate_trace"))
    peak = torch.cuda.max_memory_allocated()
    return ({"setup_s": setup_s, "table_s": table_s,
             "table_bytes": table_bytes, "table_peak_bytes": table_peak,
             "peak_bytes": peak, "from_json_s": from_json_s, **times,
             "aggregate_proof_profile": prof},
            setup_launches, path_launches)


def host_fft_g1(aff, roots, max_width: int, inv_n, host_ec):
    """The reference's radix-2 butterflies on host ints: the input
    bit-reversed, then per stage (a + [w]b, a - [w]b), times inv_n if
    given. Off the r-torsion [a]P depends on a mod ord(P), so this, not a
    DFT over Fr, is what the generic route computes there."""
    n = len(aff)
    bits = n.bit_length() - 1
    x = [aff[bitrev(i, bits)] for i in range(n)]
    m = 1
    while m < n:
        m *= 2
        half, stride = m // 2, max_width // m
        for g in range(0, n, m):
            for j in range(half):
                a = x[g + j]
                t = host_ec.g1_mul(x[g + j + half], roots[j * stride])
                x[g + j], x[g + j + half] = (host_ec.g1_add(a, t),
                                             host_ec.g1_sub(a, t))
    if inv_n is not None:
        x = [host_ec.g1_mul(p, inv_n) for p in x]
    return x


def fft_g1_generic_phase(dev, card, rng, kmods, fs13):
    """fft_g1(..., in_subgroup=False): 16 points off the r-torsion both
    ways against the host's radix-2 butterflies; at 4096 subgroup points
    inverse(forward) is the identity; at 128 and 4096 subgroup points the
    generic route equals the GLV route. Returns (results, launches of one
    forward transform at 4096)."""
    import torch

    from kzg_tpu_torch.curve import g1
    from kzg_tpu_torch.curve.fft_g1 import fft_g1
    from kzg_tpu_torch.field import fp, fr
    from kzg_tpu_torch.utils import host_ec

    r, p = fr.SPEC.modulus, fp.SPEC.modulus
    aff = []
    while len(aff) < GENERIC_OFF_POINTS:
        x = random_fr_ints(rng, 1, p)[0]
        y2 = (pow(x, 3, p) + 4) % p
        y = pow(y2, (p + 1) // 4, p)
        if y * y % p == y2 and host_ec.g1_mul((x, y), r) is not None:
            aff.append((x, y))
    pts = g1.from_affine_ints(aff, dev)
    roots = fs13.roots_of_unity_int()
    for inverse in (False, True):
        got = g1.to_affine_ints_host(fft_g1(fs13, pts, inverse,
                                            in_subgroup=False))
        want = host_fft_g1(aff, roots[::-1] if inverse else roots,
                           fs13.max_width,
                           pow(len(aff), -1, r) if inverse else None,
                           host_ec)
        check(got == want, f"the generic G1 FFT (inverse={inverse}) of "
              f"{len(aff)} points off the subgroup differs from the host "
              "butterflies")

    def sub_pts(n):
        return g1.mul(g1.generator((n,), dev),
                      fr.from_int(random_fr_ints(rng, n, r), dev))

    for n in GENERIC_SIZES:
        x = sub_pts(n)
        gen_f = fft_g1(fs13, x, in_subgroup=False)
        check(g1.to_affine_ints_host(gen_f)
              == g1.to_affine_ints_host(fft_g1(fs13, x)),
              f"the generic G1 FFT differs from the GLV route at {n} points")
    for m in kmods:
        m.reset_launches()
    fwd = fft_g1(fs13, x, in_subgroup=False)
    torch.cuda.synchronize()
    launches = counted(*kmods)
    back = fft_g1(fs13, fwd, inverse=True, in_subgroup=False)
    check(g1.to_affine_ints_host(back) == g1.to_affine_ints_host(x),
          f"inverse(forward) of the generic G1 FFT at {n} points is not "
          "the identity")
    stages = n.bit_length() - 1
    check(launches["g1_scalar_mul"] == stages
          and launches["g1_add"] == stages,
          f"the generic {n}-point transform launched K3 "
          f"{launches['g1_scalar_mul']} and g1_add {launches['g1_add']} "
          f"times, not {stages} each")
    for name in ("g1_glv_butterfly", "g1_fft_stage", "g1_window_table"):
        check(launches[name] == 0, f"the generic route launched {name}")
    ms_generic = slope_ms(lambda q: fft_g1(fs13, q, in_subgroup=False), x)
    ms_glv = slope_ms(lambda q: fft_g1(fs13, q), x)
    n_launch = sum(launches.values())
    log(f"generic G1 FFT: {len(aff)} off-subgroup points both ways equal "
        f"the host butterflies; at {GENERIC_SIZES} subgroup points equal to "
        f"the GLV route; inverse(forward) at {n} is the identity")
    log(f"[{card}] G1 FFT {n} points: generic route {ms_generic:.3f} ms, "
        f"{n_launch} launches a transform ({launches['g1_scalar_mul']} K3, "
        f"{launches['g1_add']} g1_add, {launches['fr_signed_windows']} "
        f"fr_signed_windows); GLV route {ms_glv:.3f} ms")
    return ({"points": n, "ms": ms_generic, "glv_ms": ms_glv,
             "launches_a_transform": n_launch}, launches)


def persistence_phase(dev, card, kmods, ks, fkm, coeffs, proofs):
    """Save the PeerDAS shape's KZG settings and FK20MultiSettings(n2=8192,
    l=64), load them, and hold the loaded settings' proofs (128) against
    the ones before. Returns (results, launches of the loaded settings' first
    call, which rebuilds the fixed-base tables)."""
    import tempfile

    import torch

    from kzg_tpu_torch.curve import g1
    from kzg_tpu_torch.kzg import persist

    with tempfile.TemporaryDirectory() as d:
        pk_, pf_ = os.path.join(d, "kzg.npz"), os.path.join(d, "fk20.npz")
        t = time.time()
        persist.save_kzg_settings(pk_, ks)
        persist.save_fk20_multi(pf_, fkm)
        save_s = time.time() - t
        nbytes = os.path.getsize(pk_) + os.path.getsize(pf_)
        t = time.time()
        ks_l = persist.load_kzg_settings(pk_, device=dev)
        fkm_l = persist.load_fk20_multi(pf_, ks_l)
        torch.cuda.synchronize()
        load_s = time.time() - t
    check(ks_l.secret_g2_affine == ks.secret_g2_affine,
          "the loaded [s^i]_2 differ")
    for m in kmods:
        m.reset_launches()
    t = time.time()
    got = fkm_l.da_using_fk20_multi(coeffs)
    torch.cuda.synchronize()
    first_s = time.time() - t
    launches = counted(*kmods)
    check(g1.to_affine_ints_host(got) == g1.to_affine_ints_host(proofs),
          "the loaded settings' 128 proofs differ")
    log(f"[{card}] persistence: KZG settings ({ks.secret_g1.x.shape[0]} "
        f"points) and FK20MultiSettings(n2={fkm.n2}, l={fkm.chunk_len}): "
        f"{nbytes} bytes, saved in {save_s:.3f} s, loaded in {load_s:.3f} s; "
        f"the loaded settings' first call (tables rebuilt) {first_s:.3f} s, "
        f"the same {proofs.x.shape[0]} proofs")
    return ({"file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
             "first_call_s": first_s}, launches)


def examples_phase(card):
    """The port's two examples at their defaults, each in its own process;
    each must end in its PASS line."""
    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for name, last in (("eth_blob_demo_torch", "ETH BLOB DEMO PASS"),
                       ("full_das_pipeline_torch",
                        "FULL DAS PIPELINE PASS")):
        t = time.time()
        run = subprocess.run([sys.executable,
                              os.path.join(root, "examples", name + ".py")],
                             capture_output=True, text=True, timeout=300,
                             cwd=root)
        out[name + "_s"] = time.time() - t
        lines = run.stdout.strip().splitlines()
        check(run.returncode == 0 and lines and lines[-1] == last,
              f"examples/{name}.py failed: {run.stdout[-800:]}"
              f"{run.stderr[-1500:]}")
        log(f"[{card}] examples/{name}.py at its defaults: {lines[-1]} "
            f"({out[name + '_s']:.1f} s with its process start)")
        for line in lines[:-1]:
            log(f"    {line}")
    return out


# phase 14: the ranks of the sharded paths, and the kernels each path
# must launch on some rank (the Fr cross stages: fr_add_sub, mont_mul;
# the G1 cross stages: g1_add, its operand's negation on fr_add_sub, K4)
SHARDED_DS = (2, 4)
SHARDED_TIMEOUT_S = 360
SHARDED_KERNELS = {
    "fft_2^20": ("fr_add_sub", "mont_mul", "fr_fft_block"),
    "ifft_2^20": ("fr_add_sub", "mont_mul", "fr_fft_block"),
    "fft_g1_128": ("g1_add", "fr_add_sub", "g1_glv_butterfly",
                   "g1_window_table", "g1_fft_stage"),
    "ifft_g1_128": ("g1_add", "fr_add_sub", "g1_glv_butterfly",
                    "g1_window_table", "g1_fft_stage"),
    "fft_g1_4096": ("g1_add", "fr_add_sub", "g1_glv_butterfly",
                    "g1_window_table", "g1_fft_stage"),
    "ifft_g1_4096": ("g1_add", "fr_add_sub", "g1_glv_butterfly",
                     "g1_window_table", "g1_fft_stage"),
    "brp_g1_128": (),
    "msm_4096": ("g1_add", "fr_signed_windows", "g1_sum", "g1_horner"),
    "fk20": ("fr_add_sub", "mont_mul", "fr_fft_block", "fr_signed_windows",
             "g1_fixed_base_mul", "g1_sum", "g1_add", "g1_glv_butterfly",
             "g1_window_table", "g1_fft_stage"),
}


def run_ranks(D: int, backend: str, work: str) -> list:
    """Start D ranks of tools/sharded_check.py and wait for all; any rank
    that fails or outlives SHARDED_TIMEOUT_S fails the run, and every rank
    is stopped. Returns each rank's result."""
    root = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(work, f"store{D}")
    prefix = os.path.join(work, f"ranks{D}")
    for path in [store] + [f"{prefix}.{r}.json" for r in range(D)]:
        if os.path.exists(path):
            os.remove(path)
    logs = [os.path.join(work, f"rank{D}.{r}.log") for r in range(D)]
    procs = []
    try:
        for r in range(D):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "kzg_tpu_torch.tools.sharded_check",
                     str(r), str(D), store, prefix, backend],
                    cwd=root, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.time() + SHARDED_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.time() > deadline):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"sharded rank {r} of {D} exited "
                               f"{p.returncode}:\n{tail}")
    out = []
    for r in range(D):
        with open(f"{prefix}.{r}.json") as f:
            out.append(json.load(f))
    return out


def sharded_phase(card):
    """14. The sharded paths at D = 2 and 4 ranks (module docstring)."""
    import torch

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), OUT_DIR,
                        "sharded")
    os.makedirs(work, exist_ok=True)
    res, launches = {}, {}
    for D in SHARDED_DS:
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= D else "gloo"
        t = time.time()
        ranks = run_ranks(D, backend, work)
        wall = time.time() - t
        paths = ranks[0]["paths"]
        check(set(paths) == set(SHARDED_KERNELS),
              f"sharded D={D}: paths {sorted(paths)}")
        every = {}
        for name, need in SHARDED_KERNELS.items():
            check(paths[name]["equal"] is True,
                  f"sharded D={D} {name}: not held against one device")
            union = {}
            for rk in ranks:
                for k, v in rk["paths"][name]["launches"].items():
                    union[k] = union.get(k, 0) + v
                    every[k] = every.get(k, 0) + v
            missing = [k for k in need if not union.get(k)]
            check(not missing, f"sharded D={D} {name}: no rank launched "
                  f"{missing}")
        for k, v in every.items():
            launches[k] = launches.get(k, 0) + v
        transport = ("NCCL, tensors on the cards" if backend == "nccl" else
                     "gloo, CUDA tensors staged through host memory")
        where = (f"{D} ranks on {D} cards" if backend == "nccl"
                 else f"{D} ranks on one card")
        line = "; ".join(
            f"{name} {p['ms']:.3f} ms "
            f"({100 * p['collective_ms'] / p['ms']:.1f} % collectives)"
            for name, p in paths.items())
        log(f"[{card}] phase 14, {where}: {transport}, {cards} device(s), "
            f"{wall:.1f} s with the ranks' start; every path equal to one "
            f"device; rank 0, ms a call: {line}")
        for name, p in paths.items():
            log(f"    {name}: rank 0 launches {p['launches']}, collectives "
                f"a call {p['collectives']}")
        res[f"D{D}"] = {"backend": backend, "cards": cards, "where": where,
                        "wall_s": wall,
                        "ranks": [{"rank": rk["rank"], "paths": rk["paths"]}
                                  for rk in ranks]}
    return res, launches


# phase 15: the field-chain experiments (kzg_tpu_torch/experiments), the
# counterparts of scripts/exp_montmul.py (X1), exp_mxu_mul.py (X2) and
# exp_addsub.py (X12): no path of the library runs their kernels. A
# product's dependent latency comes from one warp's chain (32 lanes) at
# two depths, CUDA events, the launch's fixed cost cancelling in the
# difference
EXP_LAT_DEPTHS = (256, 4096)
EXP_SOURCE = "kzg_tpu_torch/csrc/exp_field_kernels.cu"
EXP_MMA_KERNELS = ("mont_chain_kernel<8, 2>", "mont_chain_kernel<12, 2>",
                   "tc_mont_mul_kernel<0>", "tc_mont_mul_kernel<1>")
# an X12 op's work in word products (multiply-adds, 2 operations each;
# a 32-bit add, subtract or select is half of one): mont_mul's 2N^2 + N
# multiply-adds; add's and sub's add, subtract and select chains; the
# carry chain; the compare and select of geq+where and cond_sub
EXP_OP_WORD_PRODUCTS = {"mont_mul(x,c)": 300, "mod_add(x,x)": 18,
                        "mod_sub(m,x)": 18, "carry_fold": 6,
                        "geq+where": 12, "cond_sub": 12}


# an experiment kernel's TPU counterpart(s), by kernel
EXP_REPLACES = {
    "exp_mont_chain": "scripts/exp_montmul.py:210",
    "exp_tc_mont_mul": "scripts/exp_mxu_mul.py:257",
    "exp_op_chain": "scripts/exp_addsub.py:50",
    "exp_tuple_chain": "scripts/exp_ab_mul.py:75; scripts/exp_carry.py:81, "
                       ":103, :126; scripts/exp_calib.py:95; "
                       "scripts/exp_bisect.py:116; scripts/exp_width.py:74; "
                       "scripts/exp_pointops.py:152, :170",
    "exp_ext_chain": "scripts/exp_truth.py:74; scripts/exp_addcost.py:95",
    "exp_ext_body": "scripts/exp_bisect.py:116; scripts/exp_lazyops.py:186",
    "exp_point_chain": "scripts/exp_calib.py:129; scripts/exp_width.py:102; "
                       "scripts/exp_pointops.py:70, :127; "
                       "scripts/exp_lazyops.py:75, :131"}
# a kernel's source where it is not EXP_SOURCE
EXP_SOURCES = {"exp_point_chain": "kzg_tpu_torch/csrc/exp_point_kernels.cu"}
# a SASS instruction's opcode, after its offset and any predicate
SASS_OP = r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"


def sass_counts(lib_path: str) -> dict:
    """{kernel: {"instructions", "imad", "imma"}} from cuobjdump's SASS of
    a library: its instructions but NOPs, those of them of the IMAD
    family, and its IMMA.16832.U8.U8 (mma.sync u8 x u8 -> s32)."""
    import re

    from kzg_tpu_torch import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = symbol(part.split()[0]).split("::")[-1]
        ops = [op for op in re.findall(SASS_OP, part) if op != "NOP"]
        out[name] = {"instructions": len(ops),
                     "imad": sum(op.startswith("IMAD") for op in ops),
                     "imma": part.count("IMMA.16832.U8.U8")}
    return out


def signed_byte_digits(words, n_digits: int):
    """(lanes, N) int32 words -> (lanes, n_digits) int8 digits in
    [-128, 127] of the same integers (base 256), for torch._int_mm."""
    import torch

    b = words.contiguous().view(torch.uint8).to(torch.int32)
    digits, carry = [], torch.zeros_like(b[:, 0])
    for k in range(b.shape[1]):
        d = b[:, k] + carry
        carry = (d >= 128).to(torch.int32)
        digits.append(d - 256 * carry)
    digits.append(carry)
    out = torch.stack(digits, 1)
    out = torch.nn.functional.pad(out, (0, n_digits - out.shape[1]))
    return out.to(torch.int8)


def exp_path(phase: int, card: str, kmods, drive, need):
    """An experiments phase's entry points as its counted path: every
    count of kmods 0 just before drive() ({entry point: its JSON lines})
    and read just after; each line correct, each case of `need` launched.
    (runs, path_s, cases, launches)."""
    import torch

    from kzg_tpu_torch.experiments import kernels as ek

    for m in kmods:
        m.reset_launches()
    t = time.time()
    runs = drive()
    torch.cuda.synchronize()
    path_s = time.time() - t
    cases, launches = dict(ek.CASES), counted(*kmods)
    for lines in runs.values():
        for line in lines:
            log("    " + json.dumps(line))
            check(line["correct"] is True, f"phase {phase}: {line}")
    missing = [c for c in need if not cases.get(c)]
    check(not missing, f"phase {phase}: no launch of {missing}")
    log(f"[{card}] phase {phase}, the entry points at the scripts' shapes: "
        f"{path_s:.1f} s; launches {cases}")
    return runs, path_s, cases, launches


def on_device_of(out, ref):
    if isinstance(out, tuple):
        return tuple(o.to(r.device) for o, r in zip(out, ref))
    return out.to(ref.device)


class ExpRows:
    """The `kernels` rows of an experiments phase, a shape at a time:
    `path` names the phase's counted path, `launches` its counts."""

    def __init__(self, card: str, path: str, launches: dict):
        self.card, self.path, self.launches = card, path, launches
        self.rows, self.detail = {}, {}

    def add(self, name, key, fn, pairs, ok, match, nbytes, products,
            tc_macs=0.0, depth=1, lat_ms=None, reps=3, **extra):
        """One shape of a kernel's row: bit for bit against the plain
        version on each (kernel call, plain call) of `pairs` (the last
        one's time is the row's plain time), ok(fn()) against Python
        ints, the device time a launch of fn from a trace, the bound and
        the latency bound (lat_ms; None where the shape has none)."""
        err = 0
        for kernel_call, plain_call in pairs:
            ref, pms = once_ms(plain_call)
            out = on_device_of(kernel_call(), ref)
            check(same(out, ref), f"{name} {key} differs from its plain "
                  f"version")
            err = max(err, max_abs_err(out, ref))
        check(ok(fn()), f"{name} {key} differs from Python ints")
        call_ms = cuda_ms(fn, reps)
        dev_ms, caught = kernel_ms(fn, match, reps)
        b, by = bound_ms(nbytes, products, tc_macs)
        entry = {"shape": key, "max_abs_err": err, "ms": dev_ms,
                 "plain_ms": pms, "bound_ms": b, "bound_by": by,
                 "call_ms": call_ms, "traced": caught, "latency_ms": lat_ms,
                 **extra}
        if depth > 1:
            entry["ns_a_step"] = dev_ms / depth * 1e6
        row = self.rows.get(name)
        if row is None:
            self.rows[name] = {
                "name": name, "route": "cuda",
                "source": EXP_SOURCES.get(name, EXP_SOURCE),
                "replaces": EXP_REPLACES[name],
                "launches": self.launches[name],
                "launches_by_path": {self.path: self.launches[name]},
                **{k: entry[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")},
                "library_ms": None, "latency_ms": lat_ms, "shape": key,
                "shapes": []}
        else:
            row["shapes"].append(entry)
            row["max_abs_err"] = max(row["max_abs_err"], err)
        self.detail[f"{name} {key}"] = entry
        log(f"[{self.card}] {name} ({key}): {dev_ms:.4f} ms on the device "
            f"({caught} of {reps} traced)"
            + (f", {entry['ns_a_step']:.1f} ns a step" if depth > 1 else "")
            + f", {call_ms:.4f} ms a call; plain {pms:.1f} ms; bound "
            f"{b:.3g} ms by {by}"
            + ("" if lat_ms is None else f"; latency bound {lat_ms:.4f} ms"))
        return entry


def exp_field_phase(dev, card):
    """15. The field-chain experiments (module docstring)."""
    import torch

    from kzg_tpu_torch import build
    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.experiments import exp_addsub, exp_montmul, exp_mxu_mul
    from kzg_tpu_torch.experiments import kernels as ek
    from kzg_tpu_torch.field import kernels as fk

    t_phase = time.time()
    sass = sass_counts(build._lib_path("exp_field_kernels"))
    imma = {k: v["imma"] for k, v in sass.items()}
    for name, count in imma.items():
        check((count > 0) == (name in EXP_MMA_KERNELS),
              f"{name}: {count} IMMA.16832.U8.U8 instructions in its SASS")
    log(f"[{card}] phase 15: IMMA.16832.U8.U8 (mma.sync u8 x u8 -> s32) "
        f"in the SASS: " + ", ".join(f"{k} {v}" for k, v in imma.items()))

    need = ([f"exp_mont_chain:{f}:{v}" for f in ("Fr", "Fp")
             for v in ek.VARIANTS] + [f"exp_tc_mont_mul:{m}" for m in ek.MODES]
            + [f"exp_op_chain:{op}" for op in ek.OPS])
    runs, path_s, cases, launches = exp_path(15, card, (fk, gk, pk, ek),
                                             lambda: {
        "exp_montmul": exp_montmul.run(dev.type),
        "exp_mxu_mul": exp_mxu_mul.run(dev.type),
        "exp_addsub": exp_addsub.run(dev.type)}, need)
    check(launches["mont_mul"] > 0, "phase 15: exp_mxu_mul launched no K1")
    out = ExpRows(card, "exp_field", launches)
    detail = out.detail

    def lat_ns(fn_at):
        """A product's (an op's) dependent latency: one warp's chain."""
        d0, d1 = EXP_LAT_DEPTHS
        t0, t1 = (cuda_ms(lambda d=d: fn_at(d), 5) for d in (d0, d1))
        return (t1 - t0) / (d1 - d0) * 1e6

    # X1: 256-deep chains at 2048 lanes, Fr and Fp, variants A, B, C
    depth, lanes = exp_montmul.DEPTH, exp_montmul.LANES
    for fname in ("Fr", "Fp"):
        spec = ek.SPECS[fname]
        N = spec.n_words
        a, b = exp_montmul.inputs(spec, lanes, dev)
        a32, b32 = a[:32].contiguous(), b[:32].contiguous()
        mq, mqm = ek.pass_macs(spec)
        for v in ek.VARIANTS:
            fn = functools.partial(ek.exp_mont_chain, spec, a, b, v, depth)
            lat = lat_ns(lambda d, s=spec, v=v: ek.exp_mont_chain(
                s, a32, b32, v, d))
            # A and B: 2N^2 + N multiply-adds a product; C: N^2 (a*b) and
            # the byte products its two passes need, a lane
            products = N * N if v == "C" else 2 * N * N + N
            tc = (mq + mqm) * lanes if v == "C" else 0
            out.add("exp_mont_chain",
                    f"{fname} {v}, {lanes} lanes, depth {depth}", fn,
                    [(fn, functools.partial(ek.exp_mont_chain_plain, spec, a,
                                            b, v, depth))],
                    lambda o, s=spec: exp_montmul.check_lanes(s, a, b, o,
                                                              depth),
                    "mont_chain_kernel", 3 * 4 * N * lanes,
                    products * lanes * depth, tc * depth, depth=depth,
                    lat_ms=depth * lat / 1e6, product_latency_ns=lat)

    # X2: one Fp product a lane and its by-constant pass, at the widths;
    # K1 beside it from a trace, for the script's 1.3x decision
    FP = ek.FP
    _, _, big = exp_mxu_mul.inputs(exp_mxu_mul.WIDTHS, dev)
    mq, mqm = ek.pass_macs(FP)
    lat_hybrid = detail[f"exp_mont_chain Fp C, {exp_montmul.LANES} lanes, "
                        f"depth {exp_montmul.DEPTH}"]["product_latency_ns"]
    decisions = {}
    for W in sorted(exp_mxu_mul.WIDTHS, reverse=True):   # the row: widest
        a = big[W]
        lanes_w = [0, 1, W - 1]
        ai = exp_montmul.word_ints(a, lanes_w)
        redc_want = [x * x * FP.r_inv % FP.modulus for x in ai]
        pass_want = [x * FP.nprime % FP.r for x in ai]
        for mode in ek.MODES:
            fn = functools.partial(ek.exp_tc_mont_mul, a, a, mode)
            want = redc_want if mode == "hybrid" else pass_want
            hybrid = mode == "hybrid"
            out.add("exp_tc_mont_mul", f"{mode}, {W} lanes", fn,
                    [(fn, functools.partial(ek.exp_tc_mont_mul_plain, a, a,
                                            mode))],
                    lambda o, w=want: exp_montmul.word_ints(o, lanes_w) == w,
                    "cc_mul_nprime_kernel" if mode == "cc_pass"
                    else "tc_mont_mul_kernel",
                    (3 if hybrid else 2) * 48 * W,
                    (144 if hybrid else 78 if mode == "cc_pass" else 0) * W,
                    ((mq + mqm) if hybrid else mq if mode == "tc_pass"
                     else 0) * W,
                    lat_ms=lat_hybrid / 1e6 if hybrid else None, reps=5,
                    product_latency_ns=lat_hybrid if hybrid else None)
        k1 = functools.partial(fk.mont_mul, FP, a, a)
        check(same(k1(), ek.exp_tc_mont_mul(a, a)),
              f"K1 and the hybrid differ at {W} lanes")
        k1_ms, _ = kernel_ms(k1, "mont_mul_kernel", 5)
        hyb_ms = detail[f"exp_tc_mont_mul hybrid, {W} lanes"]["ms"]
        decisions[W] = {"k1_ms": k1_ms, "hybrid_ms": hyb_ms,
                        "speedup": k1_ms / hyb_ms,
                        "adopt": k1_ms / hyb_ms > exp_mxu_mul.ADOPT_SPEEDUP}
        log(f"[{card}] X2 at {W} lanes, device time a launch: K1 "
            f"{k1_ms:.4f} ms, hybrid {hyb_ms:.4f} ms: {k1_ms / hyb_ms:.3f}x, "
            f"adopt (above {exp_mxu_mul.ADOPT_SPEEDUP}x): "
            f"{decisions[W]['adopt']}")
    # the yardstick: one PyTorch call that computes the q pass's column
    # sums, torch._int_mm on signed byte digits (s8 x s8 -> s32) of x and
    # of n' at the widest width; the port never calls it
    W = exp_mxu_mul.WIDTHS[-1]
    a = big[W]
    dg = signed_byte_digits(a, 64)
    nd = signed_byte_digits(FP.words([FP.nprime], dev), 64)[0]
    ts = torch.zeros(64, 48, dtype=torch.int8, device=dev)
    for i in range(48):
        ts[i, i:] = nd[:48 - i]
    cols = torch._int_mm(dg, ts)
    lanes_w = [0, 1, W - 1]
    got = [sum(int(c) << (8 * k) for k, c in enumerate(cols[i].tolist()))
           % FP.r for i in lanes_w]
    check(got == [x * FP.nprime % FP.r for x in
                  exp_montmul.word_ints(a, lanes_w)],
          "torch._int_mm's column sums do not give x n' mod R")
    lib_ms = cuda_ms(lambda: torch._int_mm(dg, ts), 20)
    x2 = out.rows["exp_tc_mont_mul"]
    x2["library_ms"] = lib_ms
    x2["library_call"] = (f"torch._int_mm, signed byte digits (s8) of x and "
                          f"n': the q pass's column sums at {W} lanes")
    x2["decision"] = decisions
    log(f"[{card}] torch._int_mm, the q pass's column sums at {W} lanes: "
        f"{lib_ms:.4f} ms")

    # X12: the six ops, 256-deep chains at 2048 Fp lanes
    depth, lanes = exp_addsub.DEPTH, exp_addsub.LANES
    a = exp_addsub.inputs(lanes, dev)
    a32 = a[:32].contiguous()
    check_l = list(exp_addsub.CHECK_LANES)
    ai = exp_montmul.word_ints(a, check_l)
    for op in ek.OPS:
        fn = functools.partial(ek.exp_op_chain, a, op, depth)
        lat = lat_ns(lambda d, op=op: ek.exp_op_chain(a32, op, d))
        out.add("exp_op_chain", f"{op}, {lanes} lanes, depth {depth}", fn,
                [(fn, functools.partial(ek.exp_op_chain_plain, a, op,
                                        depth))],
                lambda o, op=op: exp_montmul.word_ints(o, check_l) == [
                    exp_addsub.expected(op, x, depth) for x in ai],
                "op_chain_kernel", 2 * 48 * lanes,
                EXP_OP_WORD_PRODUCTS[op] * lanes * depth, depth=depth,
                lat_ms=depth * lat / 1e6, reps=5, product_latency_ns=lat)
    phase_s = time.time() - t_phase
    log(f"[{card}] phase 15: {phase_s:.1f} s")
    return ({"entry_points": runs, "path_s": path_s, "phase_s": phase_s,
             "cases": cases, "imma": imma, "sass": sass, "shapes": detail,
             "x2_decision": decisions}, list(out.rows.values()), launches)


# phase 16: the product-body experiments (kzg_tpu_torch/experiments), the
# counterparts of scripts/exp_ab_mul.py (X4), exp_carry.py (X5),
# exp_truth.py (X6) and exp_addcost.py (X11): no path of the library runs
# their kernels. A product's dependent latency at each width comes from
# one warp's serial body (seven dependent products an iteration) at two
# depths, CUDA events, the launch's fixed cost cancelling in the difference
EXP_CHAIN_LAT_DEPTHS = (64, 512)
# lanes held against the plain version at exp_truth's 512 iterations
EXP_CHAIN_DEEP_LANES = 4
# the critical path of each body in dependent products an iteration
EXP_CHAIN_PATH = {"tuple3": 3, "single": 3, "serial": 7, "ext": 4}
# an extra op's dependent 13-word chains: the lazy add one add.cc chain,
# the lazy sub two, the raw add none (13 independent word adds); and its
# 32-bit word adds
EXP_EXTRA_CHAINS = {"adds": 1, "fold": 1, "subs": 2, "raw": 0}
EXP_EXTRA_ADDS = {"adds": 13, "fold": 13, "subs": 26, "raw": 13}
# the words of c where the product e = M(b, c) reads it, by the kernel
# header's audit: below 1.01p (adds0) and 7.1p < 2^384 (adds4), 12; below
# 100p (adds12, fold12), at least K m - 1.01p = 63p > 2^384 (subs), any
# 13-word value (raw), 13. Every other operand of both bodies lies below
# 2p: 12 words
EXP_EXT_C_WORDS = {"adds0": 12, "adds4": 12, "adds12": 13, "fold12": 13,
                   "subs1": 13, "subs12": 13, "raw12": 13}
# warps on each of the card's SM sub-partitions (4 an SM) for the warp
# probe: a second warp there fills what cycles a lone warp leaves idle
EXP_PROBE_WARPS = (1, 2)


def product_macs(rows: int, b_words: int = 12) -> int:
    """The 32-bit multiply-adds one REDC product over R = 2^(32 rows)
    needs: a b on a 12-word operand and a b_words one, q m on the
    modulus's 12 non-zero words, and the rows' q_i."""
    return 12 * b_words + rows * 12 + rows


def exp_chain_phase(dev, card, ptxas, exp_res):
    """16. The product-body experiments (module docstring). exp_res: phase
    15's result; the carry chain of its X12 rows (one warp's dependent
    12-word add.cc chain) is the latency bound's unit for an extra op,
    and its SASS counts hold this phase's kernels."""
    import torch

    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.experiments import (exp_ab_mul, exp_addcost,
                                           exp_carry, exp_truth)
    from kzg_tpu_torch.experiments import kernels as ek
    from kzg_tpu_torch.field import kernels as fk

    t_phase = time.time()
    op_chain_ns = next(v["product_latency_ns"]
                       for k, v in exp_res["shapes"].items()
                       if k.startswith("exp_op_chain carry_fold,"))
    regs = {k.split(":", 1)[1]: v for k, v in ptxas.items()
            if "tuple_chain_kernel" in k or "ext_chain_kernel" in k}
    sass = {k: v for k, v in exp_res["sass"].items()
            if k.startswith(("tuple_chain_kernel", "ext_chain_kernel"))}
    check(len(sass) == len(regs) and all(
        v["instructions"] > 0 for v in sass.values()),
        f"phase 16: SASS counts {sass} against ptxas's {sorted(regs)}")
    for k, v in regs.items():
        log(f"[{card}] phase 16, {k}: {v['registers']} registers, "
            f"{v['stack_frame']} bytes stack frame, {v['spill_stores']} bytes "
            f"spill stores, {v['spill_loads']} bytes spill loads; SASS "
            f"{sass[k]['instructions']} instructions, {sass[k]['imad']} IMAD")

    def drive():
        ab = exp_ab_mul.run(dev.type)
        mont12 = next(line for line in ab if line["product"] == "mont12")
        return {"exp_ab_mul": ab,
                "exp_carry": exp_carry.run(dev.type, tuple3=mont12),
                "exp_truth": [exp_truth.run(dev.type)],
                "exp_addcost": exp_addcost.run(dev.type)}

    need = ([f"exp_tuple_chain:tuple3:{p}" for p in ek.PRODUCTS]
            + ["exp_tuple_chain:single:mont12",
               "exp_tuple_chain:serial:mont12"]
            + [f"exp_ext_chain:{k}{n}" for k, n in ek.EXT_CASES])
    runs, path_s, cases, launches = exp_path(16, card, (fk, gk, pk, ek),
                                             drive, need)

    # a product's dependent latency at each width: one warp's serial body
    x = exp_ab_mul.inputs(exp_ab_mul.LANES, dev)
    x32 = x[:32].contiguous()
    d0, d1 = EXP_CHAIN_LAT_DEPTHS
    per_product = {}
    for product in ek.PRODUCTS:
        t0, t1 = (cuda_ms(lambda d=d: ek.exp_tuple_chain(
            x32, "serial", product, d), 5) for d in (d0, d1))
        per_product[product] = (t1 - t0) / ((d1 - d0) * 7) * 1e6
    log(f"[{card}] phase 16, one warp's dependent product, ns: "
        + ", ".join(f"{k} {v:.1f}" for k, v in per_product.items()))

    # the warp probe: tuple3 and serial on mont12 at 2048 lanes and at
    # 1 and 2 warps on each SM sub-partition (the block scheduler places
    # the blocks of 2 warps), CUDA events
    depth, lanes = exp_ab_mul.DEPTH, exp_ab_mul.LANES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    probe = {}
    for body in ("tuple3", "serial"):
        ms = {}
        for n in (lanes,) + tuple(sms * 4 * 32 * k for k in EXP_PROBE_WARPS):
            xs = x.repeat(-(-n // lanes), 1)[:n].contiguous()
            ms[n] = cuda_ms(lambda xs=xs, body=body: ek.exp_tuple_chain(
                xs, body, "mont12", depth), 3)
        n1, n2 = (sms * 4 * 32 * k for k in EXP_PROBE_WARPS)
        probe[body] = {"ms_by_lanes": ms, "two_over_one": ms[n2] / ms[n1]}
    log(f"[{card}] phase 16, warp probe on mont12, depth {depth}, ms a "
        f"call by lanes: " + "; ".join(
            f"{b} " + ", ".join(f"{n} {t:.4f}"
                                for n, t in v["ms_by_lanes"].items())
            + f" (2 warps a sub-partition over 1: {v['two_over_one']:.3f})"
            for b, v in probe.items()))

    out = ExpRows(card, "exp_chain", launches)
    detail = out.detail

    # X4, X5: the 7-product body, 2048 lanes, 64 iterations; the latency
    # probes (serial on the lazy products) too
    for body, product in ek.TUPLE_CASES:
        rows = ek.PRODUCT_WORDS[product]
        # and mont12's cond_sub: a subtract and a select a word
        macs = product_macs(rows) + (12 if product == "mont12" else 0)

        def run_at(d, xs=x, body=body, product=product):
            return lambda: ek.exp_tuple_chain(xs, body, product, d)

        def plain_at(d, xs=x, body=body, product=product):
            return lambda: ek.exp_tuple_chain_plain(xs, body, product, d)

        out.add("exp_tuple_chain", f"{body} {product}, {lanes} lanes, "
                f"depth {depth}", run_at(depth),
                [(run_at(8), plain_at(8)), (run_at(depth), plain_at(depth))],
                lambda o, body=body, product=product:
                exp_ab_mul.check_lanes(x, o, product, depth, body),
                "tuple_chain_kernel", 2 * 48 * lanes,
                7 * macs * lanes * depth, depth=depth,
                lat_ms=depth * EXP_CHAIN_PATH[body] * per_product[product]
                / 1e6)
    t3 = detail[f"exp_tuple_chain tuple3 mont12, {lanes} lanes, depth "
                f"{depth}"]
    detail["exp_carry tuple3 = exp_ab_mul mont12"] = t3
    # a step's time over its static SASS instructions (nearly all in the
    # loop body)
    ns_an_instruction = {
        f"{body} mont12": detail[f"exp_tuple_chain {body} mont12, {lanes} "
                                 f"lanes, depth {depth}"]["ns_a_step"]
        / sass[f"tuple_chain_kernel<{ek.BODIES.index(body)}, 0>"][
            "instructions"] for body in ("tuple3", "serial")}
    log(f"[{card}] phase 16, ns an iteration over the kernel's SASS "
        f"instructions: " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in ns_an_instruction.items()))

    # X6, X11: the lazy-domain 8-product body on the scripts' points, 64
    # iterations (X6 also 512); subs1 a check of the lazy sub's words
    depth, lanes = exp_addcost.DEPTH, exp_addcost.LANES
    pts = exp_addcost.inputs(lanes, dev)
    words = {}
    p13 = per_product["lazy13"]
    for kind, nextra in ek.EXT_CASES + ek.EXT_CHECK_CASES:
        case = f"{kind}{nextra}"

        def word_ops(d, kind=kind, nextra=nextra, case=case):
            """8 products an iteration and the 6 of to_ext and from_ext,
            e = M(b, c) on c's words; the extras' word adds (half a
            multiply-add each); the 3 cond_subs (a subtract and a select
            a word)"""
            return ((8 * d + 6) * product_macs(13)
                    + d * 12 * (EXP_EXT_C_WORDS[case] - 12)
                    + d * nextra * EXP_EXTRA_ADDS[kind] / 2 + 3 * 12)

        def run_at(d, ps=pts, kind=kind, nextra=nextra):
            return lambda: ek.exp_ext_chain(*ps, kind, nextra, d)

        def plain_at(d, ps=pts, kind=kind, nextra=nextra):
            return lambda: ek.exp_ext_chain_plain(*ps, kind, nextra, d)

        for d in ((depth, exp_truth.DEPTHS[1]) if case == "adds0"
                  else (depth,)):
            pairs = [(run_at(8), plain_at(8))]
            if d == depth:
                pairs.append((run_at(d), plain_at(d)))
            else:       # 512 iterations: a few lanes, the plain on the CPU
                few = tuple(c[:EXP_CHAIN_DEEP_LANES].contiguous()
                            for c in pts)
                pairs.append((run_at(d, few), plain_at(
                    d, tuple(c.cpu() for c in few))))
            out.add("exp_ext_chain", f"{case}, {lanes} lanes, depth {d}",
                    run_at(d), pairs,
                    lambda o, kind=kind, nextra=nextra, d=d:
                    exp_addcost.check_lanes(pts, o, kind, nextra, d),
                    "ext_chain_kernel", 6 * 48 * lanes,
                    word_ops(d) * lanes, depth=d,
                    lat_ms=(d * (EXP_CHAIN_PATH["ext"] * p13 + nextra
                                 * EXP_EXTRA_CHAINS[kind] * op_chain_ns)
                            + 2 * p13) / 1e6)      # and to_ext, from_ext
            if d == depth:
                words[case] = run_at(d)()
    check(same(words["fold12"], words["adds12"]),
          "phase 16: fold12's words differ from adds12's")
    check(all(not torch.any(w) for w in words["subs12"])
          and all(torch.any(w) for w in words["subs1"]),
          "phase 16: subs12's words are not all 0, or subs1's are")
    base = detail[f"exp_ext_chain adds0, {lanes} lanes, depth {depth}"]["ms"]
    extras = {}
    for kind, nextra in ek.EXT_CASES:
        if nextra:
            ms = detail[f"exp_ext_chain {kind}{nextra}, {lanes} lanes, "
                        f"depth {depth}"]["ms"]
            extras[f"{kind}{nextra}"] = (ms - base) / (depth * nextra) * 1e6
    log(f"[{card}] phase 16, ns an extra op beside adds0's body (device "
        f"time a launch): " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in extras.items()))
    deep = detail[f"exp_ext_chain adds0, {lanes} lanes, depth "
                  f"{exp_truth.DEPTHS[1]}"]["ms"]
    by_depth_ns = (deep - base) / ((exp_truth.DEPTHS[1] - depth) * 8) * 1e6
    log(f"[{card}] phase 16, X6 from traces: {by_depth_ns:.1f} ns a product "
        f"by the depth difference; exp_truth: {json.dumps(runs['exp_truth'][0])}")
    phase_s = time.time() - t_phase
    log(f"[{card}] phase 16: {phase_s:.1f} s")
    return ({"entry_points": runs, "path_s": path_s, "phase_s": phase_s,
             "cases": cases, "ptxas": regs, "sass": sass,
             "product_latency_ns": per_product, "warp_probe": probe,
             "ns_an_instruction": ns_an_instruction,
             "extra_op_chain_ns": op_chain_ns, "ns_an_extra": extras,
             "x6_traced_ns_a_product": by_depth_ns, "shapes": detail},
            list(out.rows.values()), launches)


# phase 17: the point-op experiments (kzg_tpu_torch/experiments), the
# counterparts of scripts/exp_calib.py (X3), exp_bisect.py (X7),
# exp_width.py (X8), exp_pointops.py (X9) and exp_lazyops.py (X10): no path
# of the library runs their kernels. Each case is held against its plain
# version on every lane at depth 8 and against Python-int models at the
# timed depth on a few lanes
EXP_POINT_CHECK_DEPTH = 8
# the registers, stack frame and spill bytes ptxas gave these functions
# before lazy.cuh and g1_jac.cuh took their code out of
# exp_field_kernels.cu and g1_point_kernels.cu (the sources before the
# move, built with the same toolkit on an H100's machine): the move must
# leave them as they were: registers, stack frame, spill stores and loads
HEADER_MOVE_PTXAS = {
    "exp_field_kernels:ext_chain_kernel<0, 0>": (122, 0, 0, 0),
    "exp_field_kernels:ext_chain_kernel<0, 12>": (108, 0, 0, 0),
    "exp_field_kernels:ext_chain_kernel<0, 4>": (110, 0, 0, 0),
    "exp_field_kernels:ext_chain_kernel<1, 12>": (112, 0, 0, 0),
    "exp_field_kernels:ext_chain_kernel<1, 1>": (122, 0, 0, 0),
    "exp_field_kernels:ext_chain_kernel<2, 12>": (118, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<0, 0>": (86, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<0, 1>": (88, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<0, 2>": (108, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<0, 3>": (126, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<1, 0>": (86, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<2, 0>": (44, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<2, 1>": (44, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<2, 2>": (48, 0, 0, 0),
    "exp_field_kernels:tuple_chain_kernel<2, 3>": (58, 0, 0, 0),
    "g1_point_kernels:g1_add_kernel": (188, 288, 0, 0),
    "g1_point_kernels:g1_double_kernel": (111, 144, 0, 0)}


class Levels:
    """A field of (value, level) pairs over a Python-int field F of
    experiments/point_kernels.py: a product's level is one more than its
    operands' largest, an add's or a sub's their largest; the formulas'
    branches follow the values. A chain's largest output level is its
    critical path in dependent products; `products` counts them all."""

    def __init__(self, F):
        self.F, self.products = F, 0

    def M(self, a, b):
        self.products += 1
        return self.F.M(a[0], b[0]), max(a[1], b[1]) + 1

    def A(self, a, b):
        return self.F.A(a[0], b[0]), max(a[1], b[1])

    def S(self, a, b):
        return self.F.S(a[0], b[0]), max(a[1], b[1])

    def b3_mul(self, a):
        return self.F.b3_mul(a[0]), a[1]

    def is_zero(self, a):
        return self.F.is_zero(a[0])

    def where(self, cond, a, b):
        return a if cond else b

    def one(self, like):
        return self.F.one(like[0]), 0

    def zero(self):
        return 0, 0


def point_chain_work(domain: str, op: str, point, depth: int) -> tuple:
    """(critical path, products) of one lane's chain: the formulas on
    Levels, to_ext and from_ext (lazy) one product each a coordinate."""
    from kzg_tpu_torch.experiments import point_kernels as ptk

    F = ptk.LazyField() if domain == "lazy" else ptk.MontField()
    L = Levels(F)
    ext = domain == "lazy"
    p = tuple((F.to_ext(v) if ext else v, int(ext)) for v in point)
    out = ptk._chain(L, domain, op, p, depth)
    return (max(lvl for _, lvl in out) + int(ext),
            L.products + (6 if ext else 0))


def exp_point_phase(dev, card, ptxas, exp_res, chain_res):
    """17. The point-op experiments (module docstring). exp_res and
    chain_res: phases 15 and 16's results; phase 16's dependent product
    latencies are the latency bounds' unit, its exp_ab_mul lazy13 line is
    exp_bisect's base."""
    import torch

    from kzg_tpu_torch import build
    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.experiments import (exp_ab_mul, exp_bisect,
                                           exp_calib, exp_lazyops,
                                           exp_pointops, exp_width)
    from kzg_tpu_torch.experiments import kernels as ek
    from kzg_tpu_torch.experiments import point_kernels as ptk
    from kzg_tpu_torch.experiments.exp_montmul import word_ints
    from kzg_tpu_torch.field import kernels as fk

    t_phase = time.time()
    new = ("point_chain_kernel", "ext_body_kernel", "tuple_chain_kernel<3",
           "tuple_chain_kernel<4", "tuple_chain_kernel<5")
    regs = {k.split(":", 1)[1]: v for k, v in ptxas.items()
            if any(n in k for n in new)}
    sass = {**{k: v for k, v in exp_res["sass"].items()
               if k.startswith(new)},
            **sass_counts(build._lib_path("exp_point_kernels"))}
    check(set(regs) <= set(sass) and len(regs) == len(ptk.POINT_CASES)
          + len(ek.EXT_BODIES) + len(ek.TUPLE_CASES_X789),
          f"phase 17: ptxas reports {sorted(regs)}, SASS {sorted(sass)}")
    for k, v in regs.items():
        log(f"[{card}] phase 17, {k}: {v['registers']} registers, "
            f"{v['stack_frame']} bytes stack frame, {v['spill_stores']} bytes "
            f"spill stores, {v['spill_loads']} bytes spill loads; SASS "
            f"{sass[k]['instructions']} instructions, {sass[k]['imad']} IMAD")
    moved = {}
    for k, before in HEADER_MOVE_PTXAS.items():
        now = ptxas.get(k)
        moved[k] = now and tuple(now[f] for f in (
            "registers", "stack_frame", "spill_stores", "spill_loads"))
        check(moved[k] == before, f"phase 17: {k} was {before} before the "
              f"header moves, is {moved[k]}")
    log(f"[{card}] phase 17, unchanged by the header moves (registers, "
        f"stack frame, spill stores, spill loads): " + ", ".join(
            f"{k} {v}" for k, v in moved.items()))

    ab = chain_res["entry_points"]["exp_ab_mul"]
    lazy13 = next(line for line in ab if line["product"] == "lazy13")

    def drive():
        return {"exp_calib": exp_calib.run(dev.type),
                "exp_bisect": exp_bisect.run(dev.type, base=lazy13),
                "exp_width": exp_width.run(dev.type),
                "exp_pointops": exp_pointops.run(dev.type),
                "exp_lazyops": exp_lazyops.run(dev.type)}

    need = ([f"exp_point_chain:{d}:{o}:{t}" for d, o, t in ptk.POINT_CASES]
            + [f"exp_tuple_chain:{b}:{p}" for b, p in ek.TUPLE_CASES_X789]
            + [f"exp_ext_body:{b}" for b in ek.EXT_BODIES])
    runs, path_s, cases, launches = exp_path(17, card, (fk, gk, pk, ek, ptk),
                                             drive, need)
    check(launches["g1_glv_butterfly"] > 0,
          "phase 17: the glv lines launched no K4")

    lat = chain_res["product_latency_ns"]
    out = ExpRows(card, "exp_point", launches)
    depth, lanes, d8 = exp_pointops.DEPTH, exp_pointops.LANES, \
        EXP_POINT_CHECK_DEPTH
    seed9 = exp_pointops.inputs(lanes, dev)
    seed3 = exp_width.exp_addcost.inputs(lanes, dev, exp_width.SEED)
    bisect = exp_bisect.points(lanes, dev)
    lane0 = tuple(word_ints(c, [0])[0] for c in seed9)
    words = {}
    for domain, op, threads in ptk.POINT_CASES:
        pts = seed9 if threads == 64 else seed3
        path, products = point_chain_work(domain, op, lane0, depth)
        macs = product_macs(13, 13) if domain == "lazy" else \
            product_macs(12) + 12

        def run_at(d, domain=domain, op=op, threads=threads, pts=pts):
            return lambda: ptk.exp_point_chain(*pts, domain, op, d, threads)

        def plain_at(d, domain=domain, op=op, threads=threads, pts=pts):
            return lambda: ptk.exp_point_chain_plain(*pts, domain, op, d,
                                                     threads)

        out.add("exp_point_chain", f"{domain} {op}, {threads} threads a "
                f"block, {lanes} lanes, depth {depth}", run_at(depth),
                [(run_at(d8), plain_at(d8))],
                lambda o, domain=domain, op=op, pts=pts:
                ptk.check_lanes(pts, o, domain, op, depth),
                "point_chain_kernel", 6 * 48 * lanes,
                products * macs * lanes, depth=depth,
                lat_ms=path * lat["lazy13" if domain == "lazy" else
                                  "mont12"] / 1e6,
                critical_path_products=path, products_a_lane=products)
        if threads == 64:
            words[(domain, op)] = run_at(depth)()
    for op in ptk.OPS:
        check(same(words[("lazy", op)], words[("ladder", op)]),
              f"phase 17: the ladder's {op} words differ from the lazy ones")

    # X7's transp, X8's serial8, X9's serial1 (mont12, sqr12)
    stack = exp_bisect.word_major(bisect)
    x9 = seed9[0]
    x3 = seed3[0]
    for body, product in ek.TUPLE_CASES_X789:
        x = {"transp": stack, "serial8": x3}.get(body, x9)
        steps = ek.SERIAL_STEPS.get(body, 7)
        path = steps if body != "transp" else 3
        macs = {"lazy13": product_macs(13), "mont12": product_macs(12) + 12,
                "sqr12": 66 + 12 + 12 * 12 + 12 + 12}[product]

        def run_at(d, x=x, body=body, product=product):
            return lambda: ek.exp_tuple_chain(x, body, product, d)

        def plain_at(d, x=x, body=body, product=product):
            return lambda: ek.exp_tuple_chain_plain(x, body, product, d)

        if body == "transp":
            def ok(o, pts=bisect):
                few = ptk.CHECK_LANES
                ins = list(zip(*(word_ints(c, few) for c in pts)))
                return word_ints(o.T, few) == [
                    exp_bisect.body_int("transp", pt, depth)[0]
                    for pt in ins]
        else:
            def ok(o, x=x, body=body, product=product):
                return exp_ab_mul.check_lanes(x, o, product, depth, body,
                                              ptk.CHECK_LANES)

        out.add("exp_tuple_chain", f"{body} {product}, {lanes} lanes, "
                f"depth {depth}", run_at(depth),
                [(run_at(d8), plain_at(d8)),
                 (run_at(depth), plain_at(depth))], ok,
                "tuple_chain_kernel", 2 * 48 * lanes
                * (3 if body == "transp" else 1),
                steps * macs * lanes * depth, depth=depth,
                lat_ms=depth * path * lat["lazy13" if product == "lazy13"
                                          else "mont12"] / 1e6)

    # X7's conv and ctx, X10's mulref
    for body in ek.EXT_BODIES:
        pts = bisect if body in ("conv", "ctx") else seed9
        needed = {"conv": 7, "ctx": 7, "indep8": 3, "dblshape": 8}[body]
        path = {"conv": 3, "ctx": 3, "indep8": 1, "dblshape": 5}[body]
        ends = 0 if body == "ctx" else 2

        def run_at(d, pts=pts, body=body):
            return lambda: ek.exp_ext_body(*pts, body, d)

        def plain_at(d, pts=pts, body=body):
            return lambda: ek.exp_ext_body_plain(*pts, body, d)

        out.add("exp_ext_body", f"{body}, {lanes} lanes, depth {depth}",
                run_at(depth), [(run_at(d8), plain_at(d8)),
                                (run_at(depth), plain_at(depth))],
                lambda o, pts=pts, body=body:
                exp_bisect.check_body_lanes(pts, o, body, depth),
                "ext_body_kernel", 6 * 48 * lanes,
                (needed * depth + 3 * ends) * product_macs(13) * lanes,
                depth=depth,
                lat_ms=(depth * path + ends) * lat["lazy13"] / 1e6)

    # X8: SM-ns a lane-op by threads a block, each domain
    sweep = {}
    for line in runs["exp_width"]:
        if line["case"] == "projdbl":
            sweep.setdefault(line["domain"], {})[line["threads"]] = \
                line["sm_ns_a_lane_op"]
    log(f"[{card}] phase 17, X8's sweep, SM-ns a lane-double by threads a "
        f"block: " + "; ".join(
            f"{dom} " + ", ".join(f"{t} {v:.1f} ({v / by[64]:.3f}x)"
                                  for t, v in by.items())
            for dom, by in sweep.items()))
    calib = {line["layer"]: line["ratio_to_mont24"]
             for line in runs["exp_calib"]}
    log(f"[{card}] phase 17, X3's ratios to mont24: " + ", ".join(
        f"{k} {v:.3f}" for k, v in calib.items()))
    phase_s = time.time() - t_phase
    log(f"[{card}] phase 17: {phase_s:.1f} s")
    return ({"entry_points": runs, "path_s": path_s, "phase_s": phase_s,
             "cases": cases, "ptxas": regs, "sass": sass,
             "header_moves": moved, "width_sweep_sm_ns": sweep,
             "calib_ratios": calib, "shapes": out.detail},
            list(out.rows.values()), launches)


def merge_rows(kernels: list, rows: list) -> None:
    """A phase's rows into `kernels`: a kernel with a row there already
    takes the phase's shapes into its row's; a new kernel adds its row."""
    for row in rows:
        first = next((k for k in kernels if k["name"] == row["name"]), None)
        if first is None:
            kernels.append(row)
            continue
        head = {k: row[k] for k in ("shape", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "latency_ms")}
        first.setdefault("shapes", []).extend([head] + row["shapes"])
        first["max_abs_err"] = max(first["max_abs_err"], row["max_abs_err"])


def add_path(kernels: list, path_launches: dict, path: str,
             launches: dict) -> None:
    """Count a phase's path in every row already in `kernels`."""
    path_launches[path] = launches
    for row in kernels:
        row["launches_by_path"][path] = launches.get(row["name"], 0)
        row["launches"] = sum(row["launches_by_path"].values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kzg_tpu_torch import build
    from kzg_tpu_torch.curve import fft_g1 as fft_mod
    from kzg_tpu_torch.curve import g1
    from kzg_tpu_torch.curve import kernels as gk
    from kzg_tpu_torch.curve.fft_g1 import reverse_bit_order_g1
    from kzg_tpu_torch.curve import fp2, g2, msm, pairing_device
    from kzg_tpu_torch.curve import serialization
    from kzg_tpu_torch.curve import pairing_kernels as pk
    from kzg_tpu_torch.curve.msm import tree_reduce
    from kzg_tpu_torch.curve.weierstrass import JacobianPoint
    from kzg_tpu_torch.das.legacy import erasure_code_recover
    from kzg_tpu_torch.das import zero_poly
    from kzg_tpu_torch.das.recovery import recover_poly_from_samples
    from kzg_tpu_torch.field import fp, fr
    from kzg_tpu_torch.field import kernels as fk
    from kzg_tpu_torch.field import limbs
    from kzg_tpu_torch.fk20 import multi as fk20_multi
    from kzg_tpu_torch.fk20 import toeplitz
    from kzg_tpu_torch.fk20.multi import FK20MultiSettings
    from kzg_tpu_torch.fk20.single import FK20SingleSettings
    from kzg_tpu_torch.kzg.setup import insecure_kzg_settings_device
    from kzg_tpu_torch.ntt.bitrev import brp_permute
    from kzg_tpu_torch.ntt.das import das_extend_interleaved
    from kzg_tpu_torch.ntt.domain import FFTSettings
    from kzg_tpu_torch.ntt.fft_fr import fft
    from kzg_tpu_torch.utils import host_ec

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    r = fr.SPEC.modulus
    rng = np.random.default_rng(SEED)

    # ---- 1. build and identify ----
    t = time.time()
    logs = build.build_all()
    build_s = time.time() - t
    log(f"build: {build_s:.1f} s ({len(logs)} libraries compiled)")
    ptxas = {}
    for name, text in logs.items():
        ptxas.update(ptxas_report(name, text))
    for fn, info in ptxas.items():
        log(f"  {fn}: {info['registers']} registers, {info['stack_frame']} "
            f"bytes stack frame, {info['spill_stores']} bytes spill stores, "
            f"{info['spill_loads']} bytes spill loads")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

    # ---- 2. kernels against their plain versions ----
    def fp_pts(n):
        """n points in the r-torsion: multiples of G through K3."""
        gen = g1.generator((n,), dev)
        sc = fr.from_int(random_fr_ints(rng, n, r), dev)
        return g1.mul(gen, sc)

    def stage_fft(x, roots, max_width, inv_scale=None, plain=False):
        """K2's per-stage route of the Fr FFT (the port's before
        fr_fft_block, kept here to hold K2 and to time it beside it): the bit
        reversal, a clone, one fr_butterfly_stage launch a stage, and for
        an inverse one fr_scale."""
        n_ = x.shape[-2]
        y = brp_permute(x, axis=-2).reshape(-1, n_, fr.N_WORDS).clone(
            memory_format=torch.contiguous_format)
        for s_ in range(1, n_.bit_length()):
            if plain:
                y = fk.fr_butterfly_stage_plain(fr.SPEC, y, roots, s_ - 1,
                                                max_width >> s_)
            else:
                fk.fr_butterfly_stage(fr.SPEC, y, roots, s_ - 1,
                                      max_width >> s_)
        if inv_scale is not None:
            c_ = fr.from_int(inv_scale, x.device)
            y = (fk.fr_scale_plain if plain else fk.fr_scale)(fr.SPEC, y, c_)
        return y

    def stage_das(fs_, x):
        """The per-level route of the interleaved DAS extension, which
        fr_das_block replaced (kept here to hold fr_das_block against it
        and to time it beside it): a clone, one fr_dif_stage launch a
        level down, one fr_butterfly_stage launch a level up, one
        fr_scale by 1/n, and the interleave."""
        rows_, n_ = x.shape[0], x.shape[1]
        k_ = n_.bit_length() - 1
        s0 = fs_.max_width // (2 * n_)
        y = x.clone()
        for k in range(k_):
            fk.fr_dif_stage(fr.SPEC, y, fs_.reverse_roots_of_unity,
                            k_ - 1 - k, 2 * (s0 << k))
        for k in range(k_ - 1, -1, -1):
            fk.fr_butterfly_stage(fr.SPEC, y, fs_.expanded_roots_of_unity,
                                  k_ - 1 - k, 2 * (s0 << k), offset=s0 << k)
        y = fk.fr_scale(fr.SPEC, y, fr.from_int(pow(n_, -1, r), x.device))
        return torch.stack((x, y), dim=2).reshape(rows_, 2 * n_, fr.N_WORDS)

    def butterfly_pair(spec, a_, b_, tw_):
        """The butterfly kernel's (hi, lo) and its plain version's, which
        must be equal word for word."""
        got_ = fk.butterfly(spec, a_, b_, tw_)
        want_ = fk.butterfly_plain(spec, a_, b_, tw_)
        check(same(got_, want_),
              f"butterfly {spec.name} differs at {a_.shape[0]} lanes "
              f"({'broadcast' if tw_.dim() == 1 else 'per-lane'} twiddle)")
        return got_, want_

    checks = {}
    ab = {}
    bf_in = {}
    for spec in (fr.SPEC, fp.SPEC):
        n = 1 << 16
        m = spec.modulus
        near = [m - 1, m - 2, m - 3, m - (1 << 32), 0, 1, 2, (1 << 255) % m]
        av = random_fr_ints(rng, n - len(near), m) + near
        bv = random_fr_ints(rng, n - len(near), m) + near[::-1]
        a, b = spec.encode(av, dev), spec.encode(bv, dev)
        ab[spec.name] = (a, b, av, bv)
        got, want = fk.mont_mul(spec, a, b), fk.mont_mul_plain(spec, a, b)
        check(same(got, want), f"mont_mul {spec.name} differs")
        checks[f"mont_mul_{spec.name}"] = max_abs_err(got, want)
        log(f"K1 mont_mul {spec.name}: {n} lanes bit-exact")
        # butterfly: per-lane twiddles (edge values in other lanes than a's
        # and b's) and one broadcast twiddle, at 2^16 lanes and at 2^16 - 3
        # (the grid-stride loop ends inside a step), each against Python
        # ints on a few lanes; 2^20 below
        tv = random_fr_ints(rng, n - len(near), m) + near[3:] + near[:3]
        tw = spec.encode(tv, dev)
        err = 0
        for nl in (n, n - 3):
            for tws in (tw[:nl], tw[-2]):
                got, want = butterfly_pair(spec, a[:nl], b[:nl], tws)
                err = max(err, max_abs_err(got, want))
                tvs = tv[:nl] if tws.dim() == 2 else [tv[-2]] * nl
                lanes = [0, 1, nl - 8, nl - 5, nl - 2, nl - 1]
                his, los = (spec.decode(t[lanes]) for t in got)
                for i, h, lo in zip(lanes, his, los):
                    check((int(h), int(lo)) ==
                          ((av[i] + bv[i] * tvs[i]) % m,
                           (av[i] - bv[i] * tvs[i]) % m),
                          f"butterfly {spec.name} lane {i} of {nl} "
                          "disagrees with ints")
        checks[f"butterfly_{spec.name}"] = err
        bf_in[spec.name] = (a, b, tw)
        log(f"butterfly {spec.name}: {n} and {n - 3} lanes bit-exact, "
            "per-lane and broadcast twiddle; six lanes of each equal "
            "Python ints")
    # the butterfly at 2^20 lanes, where bytes bound it: canonical words
    # below both moduli (the top word < 2^28), made on the card
    bf20 = {}
    for spec in (fr.SPEC, fp.SPEC):
        m, N = spec.modulus, spec.n_words
        v = torch.randint(0, 1 << 32, (3, 1 << 20, N), dtype=torch.int64,
                          generator=torch.Generator(dev).manual_seed(SEED),
                          device=dev).to(torch.int32)
        v[..., N - 1] &= 0x0FFFFFFF
        a20, b20, t20 = v
        bf20[spec.name] = (a20, b20, t20)
        for tws in (t20, t20[7]):
            got, want = butterfly_pair(spec, a20, b20, tws)
            checks[f"butterfly_{spec.name}"] = max(
                checks[f"butterfly_{spec.name}"], max_abs_err(got, want))
            for i in (0, 777777, (1 << 20) - 1):
                x_, y_, w_ = (int(spec.decode(t_)) for t_ in
                              (a20[i], b20[i], tws if tws.dim() == 1
                               else tws[i]))
                check((int(spec.decode(got[0][i])),
                       int(spec.decode(got[1][i])))
                      == ((x_ + y_ * w_) % m, (x_ - y_ * w_) % m),
                      f"butterfly {spec.name} 2^20 lane {i} disagrees "
                      "with ints")
        log(f"butterfly {spec.name}: 2^20 lanes bit-exact, per-lane and "
            "broadcast twiddle; three lanes equal Python ints")

    fs12 = FFTSettings(12, dev)
    x12 = fr.from_int(random_fr_ints(rng, 1 << 12, r), dev)
    c12 = fr.from_int(pow(1 << 12, -1, r), dev)
    got = fk.fr_scale(fr.SPEC, x12, c12)
    want = fk.fr_scale_plain(fr.SPEC, x12, c12)
    check(same(got, want), "fr_scale differs")
    checks["fr_scale"] = max_abs_err(got, want)
    log("fr_scale: 4096 lanes (2^12 inverse-FFT exit) bit-exact")

    # fr_signed_windows at part 2's 8192 scalars and at a block's 9 x 4096
    # (nine blobs committed at once), with the ends of the range, on the
    # Montgomery words that every path passes (reduced in the kernel);
    # the digits rebuild the scalars
    sw_edges = [0, 1, 8, r - 1, r - 2, int("8" * 63, 16) % r]
    sw_in = {}
    for nsw in (8192, 9 * 4096):
        sw_ints = random_fr_ints(rng, nsw - len(sw_edges), r) + sw_edges
        words = fr.from_int(sw_ints, dev)
        sw_in[nsw] = words
        got = fk.fr_signed_windows(words)
        want = fk.fr_signed_windows_plain(words)
        check(same(got, want), f"fr_signed_windows differs at {nsw} scalars")
        checks["fr_signed_windows"] = max(
            checks.get("fr_signed_windows", 0), max_abs_err(got, want))
        for v, row in zip(sw_ints[-8:], got[-8:].tolist()):
            check(sum(d << (4 * j) for j, d in enumerate(row)) == v,
                  "fr_signed_windows digits do not rebuild the scalar")
    fk.reset_launches()
    check(same(fr.scalar_windows_signed(sw_in[8192]),
               fk.fr_signed_windows_plain(sw_in[8192]))
          and fk.LAUNCHES["fr_signed_windows"] == 1
          and fk.LAUNCHES["mont_mul"] == 0,
          "fr.scalar_windows_signed is not one launch of the recoding")
    log("fr_signed_windows: 8192 and 36864 Montgomery scalars bit-exact "
        "(incl. 0, 1, 8, r-1, r-2, 0x0888...8 mod r); the digits rebuild "
        "the scalars; fr.scalar_windows_signed is one launch")

    for inverse in (False, True):
        roots12 = (fs12.reverse_roots_of_unity if inverse
                   else fs12.expanded_roots_of_unity)
        sc12 = pow(1 << 12, -1, r) if inverse else None
        got = stage_fft(x12, roots12, 1 << 12, sc12)
        want = stage_fft(x12, roots12, 1 << 12, sc12, plain=True)
        check(same(got, want), f"FFT 2^12 inverse={inverse} differs")
        check(same(got[0], fft(fs12, x12, inverse)),
              f"K2's FFT 2^12 inverse={inverse} differs from fr_fft_block's")
        checks[f"fr_butterfly_stage_{int(inverse)}"] = max_abs_err(got, want)
    log("K2 fr_butterfly_stage: whole Fr FFT 2^12 fwd+inv on one launch a "
        "stage bit-exact, and equal to fft() on fr_fft_block")

    n3 = 8192
    base = fp_pts(n3)
    inf = g1.infinity((2,), dev)
    for c in range(3):  # lanes 0-1: (1, 1, 0) infinity; 2: all-zero
        base[c][:2] = inf[c]
        base[c][2] = 0
    sv = random_fr_ints(rng, n3, r)
    sv[3:6] = [0, 1, r - 1]
    digits = fr.scalar_windows_signed(fr.from_int(sv, dev))
    got = gk.g1_scalar_mul(base, digits)
    want = gk.g1_scalar_mul_plain(base, digits)
    check(same(got, want), "g1_scalar_mul differs")
    checks["g1_scalar_mul"] = max_abs_err(got, want)
    k3_out = got
    aff = g1.to_affine_ints(JacobianPoint(*(c[:8] for c in got)))
    ins = g1.to_affine_ints(JacobianPoint(*(c[:8] for c in base)))
    check(aff == [host_ec.g1_mul(p, s) for p, s in zip(ins, sv[:8])],
          "g1_scalar_mul disagrees with the host oracle")
    log(f"K3 g1_scalar_mul: {n3} lanes bit-exact (incl. infinity, 0, 1, r-1)")

    # the G1 FFT: g1_window_table + g1_fft_stage at 16 points (dense, and
    # 4 x 4 with the inverse's 1/n folded into stage 2) and at the path's
    # 128 points (dense); K4 under a forced radix-2 plan at 128 points
    fs13 = FFTSettings(13, dev)
    checks["g1_fft_stage"] = checks["g1_window_table"] = 0
    checks["g1_glv_butterfly"] = 0
    for n_pts, plans in ((16, ((16,), (4, 4))), (128, ((128,), (2,) * 7))):
        pts_in = fp_pts(n_pts)
        for inverse in (False, True):
            dense = None
            for plan in plans:
                got = fft_mod._fft_g1_core(pts_in, 13, inverse, plan)
                with plain_path():
                    want = fft_mod._fft_g1_core(pts_in, 13, inverse, plan)
                check(same(got, want), f"G1 FFT {n_pts} plan {plan} "
                      f"inverse={inverse} differs from its plain version")
                key = "g1_glv_butterfly" if plan[0] == 2 else "g1_fft_stage"
                checks[key] = max(checks[key], max_abs_err(got, want))
                aff = g1.to_affine(got)
                if dense is None:
                    dense = aff
                check(same(aff, dense), f"G1 FFT {n_pts} plan {plan} "
                      f"inverse={inverse} differs from the dense plan")
        if n_pts == 128:
            pts128 = pts_in
    log("G1 FFT: g1_fft_stage at 16 points (dense, 4 x 4) and 128 (dense), "
        "fwd+inv, bit-exact; K4 g1_glv_butterfly under the radix-2 plan at "
        "128 points bit-exact and equal to the dense transform in affine "
        "form")
    # 16 points whose sum is zero: output 0 is the point at infinity,
    # reached by adding a point to its negation, as all-zero words
    ks16 = random_fr_ints(rng, 15, r)
    ks16.append(-sum(ks16) % r)
    zs = g1.mul(g1.generator((16,), dev), fr.from_int(ks16, dev))
    for plan in ((16,), (4, 4), (2,) * 4):
        for inverse in (False, True):
            got = fft_mod._fft_g1_core(zs, 13, inverse, plan)
            with plain_path():
                want = fft_mod._fft_g1_core(zs, 13, inverse, plan)
            check(same(got, want) and not any(bool(c[0].any()) for c in got),
                  f"G1 FFT 16 plan {plan} inverse={inverse}: the output at "
                  "infinity differs from the plain version or is not zero")
            key = "g1_glv_butterfly" if plan[0] == 2 else "g1_fft_stage"
            checks[key] = max(checks[key], max_abs_err(got, want))
    log("G1 FFT at 16 points summing to zero: output 0 all-zero words and "
        "bit-exact on the dense, 4 x 4 and radix-2 plans, fwd+inv")
    # the window tables and the fixed-base product at 2^10 lanes (the
    # scalars and edge lanes of K3's check above)
    n10 = 1 << 10
    b10 = JacobianPoint(*(c[:n10].contiguous() for c in base))
    t10 = gk.g1_window_table(b10, 64)
    check(same(t10, gk.g1_window_table_plain(b10, 64)),
          "g1_window_table (64 windows) differs")
    src = torch.randperm(n10, generator=torch.Generator().manual_seed(SEED)
                         ).to(dev, torch.int32)
    gt = gk.g1_window_table(b10, 1, src, n10)
    check(same(gt, gk.g1_window_table_plain(b10, 1, src, n10)),
          "g1_window_table (gathered) differs")
    checks["g1_window_table"] = max(max_abs_err(t10, gk.g1_window_table_plain(
        b10, 64)), max_abs_err(gt, gk.g1_window_table_plain(b10, 1, src,
                                                             n10)))
    d10 = digits[:n10].contiguous()
    got = gk.g1_fixed_base_mul(t10, d10)
    want = gk.g1_fixed_base_mul_plain(t10, d10)
    check(same(got, want), "g1_fixed_base_mul differs")
    checks["g1_fixed_base_mul"] = max_abs_err(got, want)
    check(same(g1.to_affine(got), g1.to_affine(JacobianPoint(
        *(c[:n10] for c in k3_out)))),
        "g1_fixed_base_mul differs from K3 in affine form")
    log(f"g1_window_table (64 windows, and gathered with 1) and "
        f"g1_fixed_base_mul: {n10} lanes bit-exact; the product equals K3's "
        f"in affine form")
    # two lanes a base (the base modulus of a batch of commitments on one
    # CRS's tables): lane i takes base i % 1024
    d2k = digits[:2 * n10].contiguous()
    got = gk.g1_fixed_base_mul(t10, d2k)
    want = gk.g1_fixed_base_mul_plain(t10, d2k)
    check(same(got, want), "g1_fixed_base_mul (two lanes a base) differs")
    checks["g1_fixed_base_mul"] = max(checks["g1_fixed_base_mul"],
                                      max_abs_err(got, want))
    b2k = JacobianPoint(*(torch.cat((c, c)) for c in b10))
    check(same(g1.to_affine(got), g1.to_affine(gk.g1_scalar_mul(b2k, d2k))),
          "g1_fixed_base_mul (two lanes a base) differs from K3")
    log(f"g1_fixed_base_mul: {2 * n10} lanes on {n10} bases (lane % {n10}) "
        f"bit-exact and equal to K3 in affine form")

    # g1_sum at the path shapes: FK20's l-way sum ((64, 128) points summed
    # over axis 0), the commitment's row of 4096 lanes, and the MSM's 64
    # window rows of 4096 points ((4096, 64) from window_points' gather,
    # zero digits as all-zero words, summed over axis 0). K3's outputs
    # hold infinity in lanes 0-3 (infinite bases, the scalar 0).
    def host_sum(p: JacobianPoint):
        acc = None
        for a in g1.to_affine_ints(JacobianPoint(*(c.reshape(-1, 12)
                                                   for c in p))):
            acc = host_ec.g1_add(acc, a)
        return acc

    ncm = n3 // 2       # the commitment's lanes at the path shape
    bcm = JacobianPoint(*(c[:ncm].contiguous() for c in base))
    wpts = msm.window_points(bcm, fr.from_int(sv[:ncm], dev))
    sum_cases = {
        f"FK20 64 x {n3 // 64}, axis 0": (JacobianPoint(
            *(c.reshape(64, n3 // 64, 12) for c in k3_out)), 0),
        f"commit 1 x {ncm}": (JacobianPoint(*(c[None, :ncm]
                                              for c in k3_out)), -1),
        f"MSM {ncm} x 64, axis 0": (wpts, 0)}
    checks["g1_sum"] = 0
    sums = {}
    for key, (pts_, dim) in sum_cases.items():
        got, want = gk.g1_sum(pts_, dim), gk.g1_sum_plain(pts_, dim)
        check(same(got, want), f"g1_sum {key} differs from its plain version")
        checks["g1_sum"] = max(checks["g1_sum"], max_abs_err(got, want))
        sums[key] = got
    fk20_sum, commit_sum, msm_sums = sums.values()
    check(g1.to_affine_ints(JacobianPoint(*(c[5:6] for c in fk20_sum)))
          == [host_sum(JacobianPoint(*(c[5::n3 // 64] for c in k3_out)))],
          "g1_sum (FK20 shape) disagrees with the host oracle")
    check(g1.to_affine_ints(commit_sum) == [host_sum(
        JacobianPoint(*(c[:ncm] for c in k3_out)))],
        "g1_sum (commit shape) disagrees with the host oracle")
    log(f"g1_sum: {', '.join(sum_cases)} bit-exact; the FK20 and commit "
        f"shapes equal the host oracle")
    # edge rows: one point; 13 with infinity as (1, 1, 0) and as all-zero
    # words inside; 4097 (a ragged second pass); all at infinity in both
    # encodings; P with -P; P with P
    e = JacobianPoint(*(c[8:21].clone() for c in k3_out))
    for c, i in zip(e, g1.infinity((1,), dev)):
        c[5], c[12] = i[0], 0
    inf6 = JacobianPoint(*(torch.cat((i, torch.zeros_like(i))) for i in
                           g1.infinity((3,), dev)))
    p1 = JacobianPoint(*(c[9:10] for c in k3_out))
    edge_rows = {"one": JacobianPoint(*(c[:1] for c in e)), "odd 13": e,
                 f"odd {ncm + 1}": JacobianPoint(*(c[:ncm + 1]
                                                   for c in k3_out)),
                 "infinity": inf6,
                 "P, -P": JacobianPoint(*(torch.cat((a, b)) for a, b in zip(
                     p1, (p1.x, fp.neg(p1.y), p1.z)))),
                 "P, P": JacobianPoint(*(torch.cat((c, c)) for c in p1))}
    for key, row in edge_rows.items():
        row = JacobianPoint(*(c[None].contiguous() for c in row))
        got, want = gk.g1_sum(row), gk.g1_sum_plain(row)
        check(same(got, want), f"g1_sum edge row {key} differs")
        checks["g1_sum"] = max(checks["g1_sum"], max_abs_err(got, want))
        oracle = host_sum(row)
        check(g1.to_affine_ints(got) == [oracle],
              f"g1_sum edge row {key} disagrees with the host oracle")
        check(oracle is not None or not any(bool(c.any()) for c in got),
              f"g1_sum edge row {key}: infinity is not all-zero words")
    log(f"g1_sum edge rows ({', '.join(edge_rows)}) bit-exact and equal to "
        f"the host oracle, infinity as all-zero words")
    # g1_horner for one MSM (the window sums above: it must equal the sum
    # of K3's lane products) and for three (K3's outputs as window sums)
    ws1 = JacobianPoint(*(c[None] for c in msm_sums))
    h3 = JacobianPoint(*(c[:192].reshape(3, 64, 12) for c in k3_out))
    checks["g1_horner"] = 0
    for key, w in (("1", ws1), ("3", h3)):
        got, want = gk.g1_horner(w), gk.g1_horner_plain(w)
        check(same(got, want), f"g1_horner ({key} MSMs) differs")
        checks["g1_horner"] = max(checks["g1_horner"], max_abs_err(got, want))
        if key == "1":
            check(same(g1.to_affine(got), g1.to_affine(commit_sum)),
                  "g1_horner of the window sums differs from the MSM")
    log(f"g1_horner: 1 and 3 MSMs bit-exact; one MSM over {ncm} points "
        "(window sums -> Horner) equals the sum of K3's products")

    # g1_add at 2^17 lanes (the width of PR 2-4's first MSM tree level):
    # random r-torsion points, and the edge lanes 0 P == Q under another
    # Z, 1 Q == -P, 2-3 Q at infinity as (1, 1, 0) and all-zero words,
    # 4-5 P at infinity likewise, 6 both at infinity
    n5 = 1 << 17
    P, Q = fp_pts(n5), fp_pts(n5)
    for qc, pc, k in zip(Q, P, (25, 125, 5)):
        qc[0] = fp.mul(pc[0], fp.from_int(k, dev))
        qc[1] = pc[1]
    Q.y[1] = fp.neg(P.y[1])
    inf1 = g1.infinity((1,), dev)
    for pc, qc, ic in zip(P, Q, inf1):
        qc[2], qc[3], pc[4], pc[5], pc[6], qc[6] = ic[0], 0, ic[0], 0, ic[0], 0
    edge_products = 8 + 7 + 8    # lane 0: 8 + the double's 7; lane 1: 8
    add_products = (n5 - 7) * 16 + edge_products
    got, want = gk.g1_add(P, Q), gk.g1_add_plain(P, Q)
    check(same(got, want), "g1_add differs")
    checks["g1_add"] = max_abs_err(got, want)
    head = [g1.to_affine_ints(JacobianPoint(*(c[:10] for c in t)))
            for t in (P, Q, got)]
    check(head[2] == [host_ec.g1_add(a, b) for a, b in zip(*head[:2])],
          "g1_add disagrees with the host oracle")
    got, want = gk.g1_double(P), gk.g1_double_plain(P)
    check(same(got, want), "g1_double differs")
    checks["g1_double"] = max_abs_err(got, want)
    check(g1.to_affine_ints(JacobianPoint(*(c[:10] for c in got)))
          == [host_ec.g1_add(a, a) for a in head[0]],
          "g1_double disagrees with the host oracle")
    log(f"g1_add, g1_double: {n5} lanes bit-exact (incl. P == Q, P == -Q, "
        "both infinity encodings)")

    # fr_dif_stage: the extension's first and last down-sweep levels on
    # the 8192-point domain, 4 rows of 4096 with values near r
    near = [r - 1, r - 2, 0, 1]
    xd = fr.from_int(random_fr_ints(rng, 4 * 4096 - 4, r) + near,
                     dev).reshape(4, 4096, 8)
    checks["fr_dif_stage"] = 0
    for log_half, stride in ((11, 2), (0, 4096)):
        got = fk.fr_dif_stage(fr.SPEC, xd.clone(), fs13.reverse_roots_of_unity,
                              log_half, stride)
        want = fk.fr_dif_stage_plain(fr.SPEC, xd, fs13.reverse_roots_of_unity,
                                     log_half, stride)
        check(same(got, want), f"fr_dif_stage log_half={log_half} differs")
        checks["fr_dif_stage"] = max(checks["fr_dif_stage"],
                                     max_abs_err(got, want))
    log("fr_dif_stage: 4 x 4096 Fr, widest and narrowest levels bit-exact")

    # ---- the routes of K1 and K2 (csrc/fr_route_kernels.cu) ----
    # fr_add_sub: Fr and Fp at K1's 2^16 lanes with the edge values, b
    # one element, and a (one element) broadcast against b
    checks["fr_add_sub"] = 0
    for spec in (fr.SPEC, fp.SPEC):
        a, b, av, bv = ab[spec.name]
        m = spec.modulus
        for op in ("add", "sub", "neg"):
            cases = ([(a, None)] if op == "neg"
                     else [(a, b), (a, b[-3]), (b[5], a)])
            for x_, y_ in cases:
                got = fk.fr_add_sub(spec, op, x_, y_)
                want = fk.fr_add_sub_plain(spec, op, x_, y_)
                check(same(got, want), f"fr_add_sub {spec.name} {op} differs")
                checks["fr_add_sub"] = max(checks["fr_add_sub"],
                                           max_abs_err(got, want))
        lanes = [0, 1, len(av) - 8, len(av) - 5, len(av) - 2, len(av) - 1]
        got = spec.decode(fk.fr_add_sub(spec, "sub", a, b)[lanes])
        check([int(v) for v in got] == [(av[i] - bv[i]) % m for i in lanes],
              f"fr_add_sub {spec.name} disagrees with Python ints")
    log("fr_add_sub: Fr and Fp add/sub/neg at 2^16 lanes bit-exact, same "
        "shape and both broadcast forms; edge lanes equal Python ints")

    # fr_pow: Fr at 8192 lanes (the edge values among them) with r - 2,
    # 0, 1 and a random exponent; Fp with p - 2
    checks["fr_pow"] = 0
    for spec, exps in ((fr.SPEC, (r - 2, 0, 1, random_fr_ints(rng, 1, r)[0])),
                       (fp.SPEC, (fp.SPEC.modulus - 2,))):
        a, _, av, _ = ab[spec.name]
        a8 = torch.cat((a[:8184], a[-8:]))
        for e in exps:
            got = fk.fr_pow(spec, a8, e)
            want = fk.fr_pow_plain(spec, a8, e)
            check(same(got, want), f"fr_pow {spec.name} differs")
            checks["fr_pow"] = max(checks["fr_pow"], max_abs_err(got, want))
            check([int(v) for v in spec.decode(got[-8:])]
                  == [pow(v, e, spec.modulus) for v in av[-8:]],
                  f"fr_pow {spec.name} disagrees with Python ints")
    log("fr_pow: Fr at 8192 lanes with r-2, 0, 1 and a random exponent, Fp "
        "with p-2, bit-exact; the edge lanes equal Python ints")

    # fr_batch_inv: 8192 lanes (one launch) and 2^16 (three), zero lanes
    # mixed in
    checks["fr_batch_inv"] = 0
    for n_inv, want_launches in ((8192, 1), (1 << 16, 3)):
        vi = random_fr_ints(rng, n_inv, r)
        for k in list(range(0, n_inv, 97)) + [1, 31, 32, n_inv - 1]:
            vi[k] = 0
        xi = fr.from_int(vi, dev)
        before = fk.LAUNCHES["fr_batch_inv"]
        got = fk.fr_batch_inv(fr.SPEC, xi)
        check(fk.LAUNCHES["fr_batch_inv"] - before == want_launches,
              f"fr_batch_inv at {n_inv} lanes: not {want_launches} launches")
        want = fk.fr_batch_inv_plain(fr.SPEC, xi)
        check(same(got, want), f"fr_batch_inv {n_inv} differs")
        checks["fr_batch_inv"] = max(checks["fr_batch_inv"],
                                     max_abs_err(got, want))
        lanes = [0, 1, 2, 31, 32, 33, n_inv - 2, n_inv - 1]
        check([int(v) for v in fr.to_int(got[lanes])]
              == [pow(vi[i], -1, r) if vi[i] else 0 for i in lanes],
              f"fr_batch_inv {n_inv} disagrees with Python ints")
        if n_inv == 8192:
            inv_in = xi
    log("fr_batch_inv: 8192 lanes (1 launch) and 2^16 (3 launches) with zero "
        "lanes bit-exact; spot lanes equal Python ints")

    # fr_fft_block: the product tree's batches (32 x 256 ... 1 x 8192) and
    # FK20's 64 x 128, forward and inverse (scaled in the last pass),
    # against the plain passes and K2's per-stage route; at 8192 also a
    # plan of 4-stage tiles (4 passes)
    checks["fr_fft_block"] = 0
    for rows_, width in ((32, 256), (16, 512), (8, 1024), (4, 2048),
                         (2, 4096), (1, 8192), (64, 128)):
        xf = fr.from_int(random_fr_ints(rng, rows_ * width, r), dev).reshape(
            rows_, width, 8)
        for inverse in (False, True):
            roots_ = (fs13.reverse_roots_of_unity if inverse
                      else fs13.expanded_roots_of_unity)
            sc = pow(width, -1, r) if inverse else None
            before = fk.LAUNCHES["fr_fft_block"]
            got = fk.fr_fft_block(fr.SPEC, xf, roots_, 8192, sc)
            passes = fk.LAUNCHES["fr_fft_block"] - before
            check(passes == len(fk.fft_plan(width.bit_length() - 1)) <= 2,
                  f"fr_fft_block {rows_} x {width}: {passes} launches")
            want = fk.fr_fft_block_plain(fr.SPEC, xf, roots_, 8192, sc)
            check(same(got, want), f"fr_fft_block {rows_} x {width} "
                  f"inverse={inverse} differs from its plain version")
            check(same(got, stage_fft(xf, roots_, 8192, sc)),
                  f"fr_fft_block {rows_} x {width} inverse={inverse} differs "
                  "from K2's per-stage route")
            checks["fr_fft_block"] = max(checks["fr_fft_block"],
                                         max_abs_err(got, want))
        if width == 8192:
            got = fk.fr_fft_block(fr.SPEC, xf, fs13.expanded_roots_of_unity,
                                  8192, None, 4)
            check(same(got, fk.fr_fft_block_plain(
                fr.SPEC, xf, fs13.expanded_roots_of_unity, 8192)),
                "fr_fft_block 8192 in 4-stage tiles differs")
            fft_in = xf
    log("fr_fft_block: 32 x 256 ... 1 x 8192 and 64 x 128, fwd and inverse, "
        "bit-exact against the plain passes and K2's route, at most 2 "
        "launches; 8192 in 4-stage tiles (4 passes) bit-exact")

    # fr_zero_poly_leaves: 64 full leaves (4096 of 8192 missing), and 130
    # missing (2 full leaves, a partial one, a padding leaf)
    checks["fr_zero_poly_leaves"] = 0
    for m_miss in (4096, 130):
        miss = np.sort(rng.choice(8192, size=m_miss, replace=False))
        idx_, valid_, g_ = zero_poly.leaf_layout(fs13, miss, 8192, 1)
        got = fk.fr_zero_poly_leaves(fr.SPEC, fs13.expanded_roots_of_unity,
                                     idx_, valid_)
        want = fk.fr_zero_poly_leaves_plain(
            fr.SPEC, fs13.expanded_roots_of_unity, idx_, valid_)
        check(same(got, want), f"fr_zero_poly_leaves ({g_} leaves, "
              f"{m_miss} factors) differs")
        checks["fr_zero_poly_leaves"] = max(checks["fr_zero_poly_leaves"],
                                            max_abs_err(got, want))
        if m_miss == 4096:
            leaves_in = (idx_, valid_)
        else:
            check(fr.to_int(got[3]).tolist() == [1] + [0] * 127,
                  "the padding leaf is not 1")
    log("fr_zero_poly_leaves: 64 full leaves, and 2 full + 1 partial + 1 "
        "padding leaf, bit-exact; the padding leaf is 1")

    # fr_das_block: the DAS extension of one blob and of a block's 9
    # (EIP-7691's most), values near r among them, odds and interleaved,
    # in 3 launches, against the plain passes; the interleaved blobs also
    # against the per-level route
    checks["fr_das_block"] = 0
    das_tables = (fs13.reverse_roots_of_unity, fs13.expanded_roots_of_unity)
    das_in = {}
    for rows_ in (1, 9):
        xe = fr.from_int(random_fr_ints(rng, rows_ * 4096 - 4, r) + near,
                         dev).reshape(rows_, 4096, 8)
        das_in[rows_] = xe
        for inter in (False, True):
            before = fk.LAUNCHES["fr_das_block"]
            got = fk.fr_das_block(fr.SPEC, xe, *das_tables, 8192, inter)
            passes = fk.LAUNCHES["fr_das_block"] - before
            check(passes == len(fk.das_plan(12)) == 3,
                  f"fr_das_block {rows_} x 4096: {passes} launches")
            want = fk.fr_das_block_plain(fr.SPEC, xe, *das_tables, 8192,
                                         inter)
            check(same(got, want), f"fr_das_block {rows_} x 4096 "
                  f"interleave={inter} differs from its plain version")
            checks["fr_das_block"] = max(checks["fr_das_block"],
                                         max_abs_err(got, want))
            if inter:
                check(same(got[:, 0::2], xe),
                      "fr_das_block does not keep the evens")
        got = fk.fr_das_block(fr.SPEC, xe, *das_tables, 8192, True)
        check(same(got, stage_das(fs13, xe)), f"fr_das_block {rows_} x 4096 "
              "differs from the per-level route")
    log("fr_das_block: 1 x 4096 and 9 x 4096, odds and interleaved, in 3 "
        "passes, bit-exact against the plain passes and equal to the "
        "per-level route")

    # ---- 3. Fr FFT at 2^20 ----
    fs20 = FFTSettings(20, dev)
    vals = random_fr_ints(rng, 1 << 20, r)
    x20 = fr.from_int(vals, dev)
    before = fk.LAUNCHES["fr_fft_block"]
    y20 = fft(fs20, x20)
    fft20_launches = fk.LAUNCHES["fr_fft_block"] - before
    check(fft20_launches <= 3, f"FFT 2^20 took {fft20_launches} launches")
    back = fft(fs20, y20, inverse=True)
    check(same(back, x20), "FFT 2^20 roundtrip failed")
    w20 = fs20.root_of_unity_int
    idx = [0, 1, 777777]
    ys = fr.to_int(y20[idx])
    for i, y in zip(idx, ys):
        check(int(y) == eval_poly(vals, pow(w20, i, r), r), f"FFT out {i}")
    check(same(y20, stage_fft(x20, fs20.expanded_roots_of_unity,
                              1 << 20)[0]),
          "FFT 2^20 differs from K2's per-stage route")
    log(f"Fr FFT 2^20: {fft20_launches} fr_fft_block launches; roundtrip "
        f"exact; outputs {idx} match direct evaluation; equal to K2's "
        f"per-stage route")

    # ---- 4. main path at the PeerDAS shape ----
    n, n2, l = 4096, 8192, 64
    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    t = time.time()
    ks = insecure_kzg_settings_device(SECRET, n, fs13, g2_indices=(1, l))
    torch.cuda.synchronize()
    crs_s = time.time() - t
    crs_aff = g1.to_affine_ints(JacobianPoint(*(c[[0, 1, n - 1]]
                                                for c in ks.secret_g1)))
    gen = host_ec.g1_generator()
    check(crs_aff == [host_ec.g1_mul(gen, pow(SECRET, i, r))
                      for i in (0, 1, n - 1)], "device CRS is wrong")
    t = time.time()
    fkm = FK20MultiSettings(ks, n2, l)
    torch.cuda.synchronize()
    setup_s = time.time() - t
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t = time.time()
    tables = fkm.x_ext_fft_tables
    torch.cuda.synchronize()
    table_s = time.time() - t
    table_bytes = tables.numel() * tables.element_size()
    table_peak = torch.cuda.max_memory_allocated() - mem0
    # the CRS's fixed-base tables, which every commitment reads
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t = time.time()
    crs_tables = ks.secret_g1_tables
    torch.cuda.synchronize()
    crs_table_s = time.time() - t
    crs_table_bytes = crs_tables.numel() * crs_tables.element_size()
    crs_table_peak = torch.cuda.max_memory_allocated() - mem0
    setup_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"CRS (4096 points, K3): {crs_s:.2f} s; FK20 settings "
        f"(64 x 128-point G1 FFTs, batched): {setup_s:.2f} s; fixed-base "
        f"tables ({tables.shape[0]} x {tables.shape[1]} bases x 64 windows x "
        f"8): {table_s:.3f} s, {table_bytes} bytes, peak {table_peak} bytes "
        f"above the settings; the CRS's tables ({n} bases): "
        f"{crs_table_s:.3f} s, {crs_table_bytes} bytes, peak "
        f"{crs_table_peak} bytes above them")
    log(f"setup launches: {json.dumps(setup_launches)}")
    for name in ("g1_scalar_mul", "g1_window_table", "g1_fft_stage"):
        check(setup_launches[name] > 0, f"{name} was not launched in setup")

    blob_ints = random_fr_ints(rng, n, r)
    blob = fr.from_int(blob_ints, dev)

    def blob_to_proofs(b):
        coeffs = fft(fs13, brp_permute(b, axis=-2), inverse=True)
        return coeffs, fkm.da_using_fk20_multi(coeffs)

    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    coeffs, proofs = blob_to_proofs(blob)
    torch.cuda.synchronize()
    fk20_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"proof path launches: {json.dumps(fk20_launches)}")
    for name in PATH_KERNELS:
        check(fk20_launches[name] > 0,
              f"{name} was not launched on the proof path")
    check(fk20_launches["g1_sum"] == 1 and fk20_launches["g1_add"] == 0,
          "the proof path must launch g1_sum once and g1_add never")
    check(fk20_launches["mont_mul"] == 0,
          "the proof path launched K1 (mont_mul)")
    check(proofs.x.shape == (n2 // l, fp.N_WORDS),
          f"proofs have shape {tuple(proofs.x.shape)}")

    coeff_ints = [int(v) for v in fr.to_int(coeffs)]
    w13 = fs13.root_of_unity_int
    for i in (0, 5, n - 1):
        check(eval_poly(coeff_ints, pow(w13, fs13.max_width // n * i, r), r)
              == blob_ints[bitrev(i, n.bit_length() - 1)],
              "blob -> coefficients is wrong")
    # the plain path builds its own 64-window tables from the part-1
    # points on g1_window_table's plain version, and runs on them
    with plain_path():
        plain_tables = msm.fixed_base_tables(fkm.x_ext_fft_files)
    check(same(tables, plain_tables),
          "the settings' fixed-base tables differ from their plain version")
    checks["g1_window_table"] = max(checks["g1_window_table"],
                                    max_abs_err(tables, plain_tables))
    log(f"g1_window_table: the settings' {tables.shape[0]} x "
        f"{tables.shape[1]} bases x 64 windows bit-exact")
    fkm_plain = copy.copy(fkm)
    fkm_plain.x_ext_fft_tables = plain_tables
    with plain_path():
        plain = fkm_plain.da_using_fk20_multi(coeffs)
    got_aff = g1.to_affine_ints(proofs)
    check(got_aff == g1.to_affine_ints(plain),
          "proofs differ from the plain path")
    check(got_aff == oracle_proofs(coeff_ints, n2, l, SECRET, r, host_ec),
          "proofs differ from the host oracle")
    log("proof path: 128 proofs equal the plain path and the host oracle")
    # the fixed-base product of part 2 at the path's 8192 lanes against its
    # plain version on the plain tables, and against K3 on the same
    # points and scalars
    tcs = torch.stack([fk20_multi.toeplitz_coeffs_step_strided(coeffs, i, l)
                       for i in range(l)])
    coeff_fft = fft(fs13, tcs)
    got = toeplitz.toeplitz_part2(fs13, tcs, tables)
    part2 = got
    with plain_path():
        want = toeplitz.toeplitz_part2(fs13, tcs, plain_tables)
    check(same(got, want),
          "g1_fixed_base_mul differs from its plain version at 8192 lanes")
    checks["g1_fixed_base_mul"] = max(checks["g1_fixed_base_mul"],
                                      max_abs_err(got, want))
    want = g1.mul(fkm.x_ext_fft_files, coeff_fft)
    check(same(g1.to_affine(got), g1.to_affine(want)),
          "the fixed-base product differs from K3 at 8192 lanes")
    del plain_tables, fkm_plain
    log(f"g1_fixed_base_mul: the path's {l} x {n2 // l} lanes bit-exact "
        f"against the plain version and equal to K3 (g1.mul) in affine form")

    # ---- 5. the producer path at the PeerDAS shape ----
    data = fr.from_int(random_fr_ints(rng, n, r), dev)
    evens = brp_permute(data, axis=-2)

    def producer(ev):
        ext = das_extend_interleaved(fs13, ev)
        cf = fft(fs13, ext, inverse=True)
        return ext, cf, ks.commit_to_poly(cf[:n]), fkm.fk20_multi_da_optimized(cf)

    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    ext, cf, commit, proofs2 = producer(evens)
    torch.cuda.synchronize()
    launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"producer path launches: {json.dumps(launches)}")
    for name in PATH_KERNELS + EXTENSION_KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched on the producer path")
    for name in ("g1_double", "mont_mul") + STAGE_DAS_KERNELS:
        check(launches[name] == 0, f"the producer path launched {name}")
    check(ext.shape == (n2, fr.N_WORDS) and same(ext[0::2], evens),
          "the extension does not keep the evens")
    with plain_path():
        plain_ext = das_extend_interleaved(fs13, evens)
    check(same(ext, plain_ext), "the extension differs from the plain path")
    checks["das_extension"] = max_abs_err(ext, plain_ext)
    cf_ints = [int(v) for v in fr.to_int(cf)]
    check(all(v == 0 for v in cf_ints[n:]), "top half of coefficients != 0")
    commit_aff = g1.to_affine_ints(JacobianPoint(*(c[None]
                                                    for c in commit)))[0]
    check(commit_aff
          == host_ec.g1_mul(gen, eval_poly(cf_ints[:n], SECRET % r, r)),
          "the commitment differs from the host oracle")
    crs_n = JacobianPoint(*(c[:n] for c in ks.secret_g1))
    check(same(g1.to_affine(msm.lin_comb_g1(crs_n, cf[:n])),
               g1.to_affine(commit)),
          "the commitment differs from the variable-base lin_comb_g1")
    # the plain route on the plain CRS tables, rebuilt from the CRS by the
    # plain table version; both must equal the kernels' word for word
    t = time.time()
    with plain_path():
        plain_crs_tables = msm.fixed_base_tables(ks.secret_g1)
    torch.cuda.synchronize()
    plain_crs_table_s = time.time() - t
    check(same(crs_tables, plain_crs_tables),
          "the CRS's fixed-base tables differ from their plain version")
    checks["g1_window_table"] = max(checks["g1_window_table"], max_abs_err(
        crs_tables, plain_crs_tables))
    ks_plain = copy.copy(ks)
    ks_plain.secret_g1_tables = plain_crs_tables
    with plain_path():
        plain_commit = ks_plain.commit_to_poly(cf[:n])
    check(same(commit, plain_commit),
          "the commitment differs from the plain route")
    del plain_crs_tables, ks_plain
    log(f"commitment: equals the host oracle, the variable-base lin_comb_g1 "
        f"(affine) and the plain route on the plain CRS tables (words); the "
        f"{n} x 64-window CRS tables equal their plain rebuild "
        f"({plain_crs_table_s:.1f} s)")
    check(g1.to_affine_ints(reverse_bit_order_g1(proofs2))
          == oracle_proofs(cf_ints[:n], n2, l, SECRET, r, host_ec),
          "producer proofs differ from the host oracle")
    log("producer path: 8192-value extension equals the plain path, top "
        "half of coefficients zero, commitment and 128 proofs equal the "
        "host oracle")

    # ---- 6. the reconstruction path at the PeerDAS shape ----
    # cell k holds the extension's natural indices bitrev(l k + j), j < l:
    # the cells are runs of the reverse-bit-ordered extension
    bits = n2.bit_length() - 1
    n_cells = n2 // l
    held = sorted(rng.choice(n_cells, size=n_cells // 2,
                             replace=False).tolist())
    missing = sorted(bitrev(l * k + j, bits) for k in range(n_cells)
                     if k not in held for j in range(l))
    samples = ext.clone()
    samples[missing] = fr.from_int(random_fr_ints(rng, len(missing), r), dev)

    def reconstruct(s):
        rec = recover_poly_from_samples(fs13, s, missing)
        rcf = fft(fs13, rec, inverse=True)
        return (rec, rcf, ks.commit_to_poly(rcf[:n]),
                fkm.fk20_multi_da_optimized(rcf))

    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    rec, rcf, rcommit, rproofs = reconstruct(samples)
    torch.cuda.synchronize()
    rec_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"reconstruction path launches: {json.dumps(rec_launches)}")
    for name in PATH_KERNELS + RECOVERY_KERNELS:
        check(rec_launches[name] > 0,
              f"{name} was not launched on the reconstruction path")
    check(rec_launches["g1_double"] == 0,
          "the reconstruction path launched g1_double")
    check(rec_launches["fr_butterfly_stage"] == 0,
          "the reconstruction path launched K2 (fr_butterfly_stage)")
    check(len(missing) == n2 // 2 and not same(samples, ext),
          "the samples do not miss half the extension")
    check(same(rec, ext), "recovery differs from the extension")
    check(same(rcf, cf) and not bool(rcf[n:].any()),
          "recovered coefficients differ or their top half is not zero")
    check(g1.to_affine_ints(JacobianPoint(*(c[None] for c in rcommit)))
          == g1.to_affine_ints(JacobianPoint(*(c[None] for c in commit))),
          "the recomputed commitment differs from the producer's")
    check(g1.to_affine_ints(rproofs) == g1.to_affine_ints(proofs2),
          "the recomputed proofs differ from the producer's")
    log(f"reconstruction path: {len(held)} of {n_cells} cells held, "
        f"{len(missing)} values recovered exactly; commitment and "
        f"{n_cells} proofs equal the producer's")
    # the recovery alone, with every K1 launch's lane count: no Fermat
    # ladder of one-lane launches (only powers_of's doublings are one lane)
    k1_lanes = []
    launch_k1 = fk._launch_mont_mul

    def counted_k1(spec, a_, b_, what):
        k1_lanes.append(a_.numel() // spec.n_words)
        return launch_k1(spec, a_, b_, what)

    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    fk._launch_mont_mul = counted_k1
    try:
        rec1 = recover_poly_from_samples(fs13, samples, missing)
        torch.cuda.synchronize()
    finally:
        fk._launch_mont_mul = launch_k1
    recovery_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    one_lane_k1 = sum(1 for k in k1_lanes if k == 1)
    log(f"recovery launches: {json.dumps(recovery_launches)}; K1 launches "
        f"of one lane: {one_lane_k1}")
    check(same(rec1, ext), "the recovery alone differs from the extension")
    for name in RECOVERY_KERNELS + ("fr_fft_block", "mont_mul"):
        check(recovery_launches[name] > 0,
              f"{name} was not launched in the recovery")
    check(recovery_launches["fr_butterfly_stage"] == 0,
          "the recovery launched K2 (fr_butterfly_stage)")
    check(recovery_launches["mont_mul"] < 150,
          f"the recovery launched K1 {recovery_launches['mont_mul']} times")
    check(one_lane_k1 <= 2 * bits + 2,
          f"the recovery made {one_lane_k1} one-lane K1 launches: a ladder")
    before = fk.LAUNCHES["fr_fft_block"]
    fft(fs13, rec1)
    fft8192_launches = fk.LAUNCHES["fr_fft_block"] - before
    check(fft8192_launches <= 2,
          f"an 8192-point FFT took {fft8192_launches} launches")

    # the legacy pipeline against the modern one at n = 1024, half missing
    n_leg = 1024
    fs11 = FFTSettings(n_leg.bit_length(), dev)
    lcf = fr.from_int(random_fr_ints(rng, n_leg // 2, r) + [0] * (n_leg // 2),
                      dev)
    lev = fft(fs11, lcf)
    lmiss = sorted(rng.choice(n_leg, size=n_leg // 2, replace=False).tolist())
    lsamp = lev.clone()
    lsamp[lmiss] = 0
    t = time.time()
    legacy = erasure_code_recover(fs11, lsamp, lmiss)
    torch.cuda.synchronize()
    legacy_s = time.time() - t
    modern = recover_poly_from_samples(fs11, lsamp, lmiss)
    check(same(legacy, modern) and same(modern, lev),
          "legacy and modern recovery disagree at n = 1024")
    log(f"legacy erasure_code_recover = recover_poly_from_samples at "
        f"n = {n_leg}, half missing ({legacy_s:.2f} s)")

    # ---- 7. the proof API at full width ----
    s_r = SECRET % r

    def single_proof_oracle(z: int):
        """[q(s)]G, q = (p - p(z)) / (x - z) by synthetic division of the
        blob's coefficients."""
        q, acc = [0] * (n - 1), 0
        for i in range(n - 1, 0, -1):
            acc = (cf_ints[i] + z * acc) % r
            q[i - 1] = acc
        return host_ec.g1_mul(gen, eval_poly(q, s_r, r))

    zpt = random_fr_ints(rng, 1, r)[0]
    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    for method in ("auto", "serial"):
        pf = ks.compute_proof_single(cf[:n], zpt, method=method)
        check(g1.to_affine_ints(JacobianPoint(*(c[None] for c in pf)))
              == [single_proof_oracle(zpt)],
              f"compute_proof_single ({method}) differs from the host oracle")
    # cell k is the coset w^bitrev(k) <w_l>, whose proof is the natural
    # FK20 output bitrev(k)
    w2 = pow(fs13.root_of_unity_int, fs13.max_width // n2, r)  # order n2
    cell = held[0]
    ci = bitrev(cell, n_cells.bit_length() - 1)
    t = time.time()
    pm = ks.compute_proof_multi(cf[:n], pow(w2, ci, r), l)
    torch.cuda.synchronize()
    proof_multi_s = time.time() - t
    api_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"proof API launches: {json.dumps(api_launches)}")
    for name in ("fr_add_sub", "fr_pow"):
        check(api_launches[name] > 0,
              f"{name} was not launched by the proof API")
    check(g1.to_affine_ints(JacobianPoint(*(c[None] for c in pm)))
          == g1.to_affine_ints(JacobianPoint(*(c[ci:ci + 1]
                                               for c in proofs2))),
          "compute_proof_multi differs from the cell's FK20 proof")
    log(f"proof API: compute_proof_single auto = serial = host oracle; "
        f"compute_proof_multi for cell {cell} (coset w^{ci}, "
        f"{proof_multi_s:.2f} s) = its FK20 proof")

    t = time.time()
    ks2 = insecure_kzg_settings_device(SECRET, n2, fs13)
    fks = FK20SingleSettings(ks2, n2)
    fks.x_ext_fft_tables
    torch.cuda.synchronize()
    single_setup_s = time.time() - t
    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    sproofs = fks.da_using_fk20(cf[:n])
    torch.cuda.synchronize()
    single_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"FK20 single launches: {json.dumps(single_launches)}")
    for name in ("g1_fixed_base_mul", "g1_window_table", "g1_fft_stage"):
        check(single_launches[name] > 0,
              f"{name} was not launched on the FK20 single path")
    check(sproofs.x.shape == (n2, fp.N_WORDS), "FK20 single proof shape")
    spots = sorted(rng.choice(n2, size=8, replace=False).tolist())
    check(g1.to_affine_ints(JacobianPoint(*(c[spots] for c in sproofs)))
          == [single_proof_oracle(pow(w2, bitrev(i, bits), r))
              for i in spots],
          "FK20 single proofs differ from the host oracle")
    log(f"FK20 single: {n2}-point CRS and settings {single_setup_s:.2f} s; "
        f"da_using_fk20 gives {n2} proofs, {spots} equal the host oracle")

    # ---- 8. the verification path at the PeerDAS shape ----
    # A DAS consumer's check of a blob's 128 cells (cell j: the coset
    # x_j <w_64>, x_j = w13^j, its values ext[j + 128 i], i < 64, in the
    # coset's natural order), on the producer's commitment and proofs sent
    # as 48-byte compressed points.
    n_cells = n2 // l
    xs_v = [pow(w2, j, r) for j in range(n_cells)]
    ys_v = ext.reshape(l, n_cells, fr.N_WORDS).transpose(0, 1).contiguous()
    sent = [commit_aff] + g1.to_affine_ints(proofs2)
    wire = [serialization.compress_g1(a) for a in sent]
    t = time.time()
    got_pts = serialization.decompress_g1_batch(wire, device=dev)
    decompress_s = time.time() - t
    check(got_pts == sent, "decompressed points differ from those sent")
    commit_v = JacobianPoint(*(c[0] for c in g1.from_affine_ints(
        got_pts[:1], dev)))
    proofs_v = g1.from_affine_ints(got_pts[1:], dev)
    fk.reset_launches()
    gk.reset_launches()
    pk.reset_launches()
    t = time.time()
    verdicts = ks.check_proof_multi_batch(commit_v, proofs_v, xs_v, ys_v)
    torch.cuda.synchronize()
    verify_first_s = time.time() - t
    verify_launches = {**fk.LAUNCHES, **gk.LAUNCHES, **pk.LAUNCHES}
    log(f"verification path launches: {json.dumps(verify_launches)}")
    for name in VERIFY_KERNELS:
        check(verify_launches[name] > 0,
              f"{name} was not launched on the verification path")
    # the bilinear form: no K-a and no G2 sub; the lines of G2 and [s^l]_2
    # once (this first call fills the settings' cache), K-b's evaluation
    # and K-c once; fr_add_sub only for the two G1 negations of a1
    for name, want in (("g2_scalar_mul", 0), ("pairing_lines", 1),
                       ("pairing_miller_eval", 1),
                       ("pairing_final_exp", 1)):
        check(verify_launches[name] == want,
              f"the verification path launched {name} "
              f"{verify_launches[name]} times, not {want}")
    check(verify_launches["fr_add_sub"] <= 2,
          f"the verification path launched fr_add_sub "
          f"{verify_launches['fr_add_sub']} times (the G2 sub is gone)")
    check(verdicts == [True] * n_cells,
          f"cells failed the batched check: "
          f"{[j for j, v in enumerate(verdicts) if not v]}")
    # tampered: cell 7 carries cell 8's proof, one value of cell 100 is off
    bad_proof, other, bad_ys = 7, 8, 100
    proofs_t = JacobianPoint(*(c.clone() for c in proofs_v))
    for c in proofs_t:
        c[bad_proof] = c[other]
    ys_t = ys_v.clone()
    ys_t[bad_ys, 5] = fr.add(ys_t[bad_ys, 5], fr.from_int(1, dev))
    verdicts_t = ks.check_proof_multi_batch(commit_v, proofs_t, xs_v, ys_t)
    check([j for j, v in enumerate(verdicts_t) if not v]
          == [bad_proof, bad_ys],
          f"tampered lanes: {[j for j, v in enumerate(verdicts_t) if not v]}"
          f" are False, not [{bad_proof}, {bad_ys}]")
    host_cells = (0, bad_proof, other, bad_ys)
    host_v = [ks.check_proof_multi(
        commit_v, JacobianPoint(*(c[j] for c in proofs_t)), xs_v[j], ys_t[j])
        for j in host_cells]
    check(host_v == [verdicts_t[j] for j in host_cells],
          f"the host checks {host_v} differ from the batch's")
    log(f"verification: {len(wire)} points decompressed on the card "
        f"({decompress_s:.3f} s, subgroup check on K3) equal those sent; "
        f"check_proof_multi_batch: all {n_cells} cells True "
        f"(first call {verify_first_s:.3f} s); tampered proof of cell "
        f"{bad_proof} and value of cell {bad_ys}: exactly those False; the "
        f"host checks of cells {host_cells} agree ({host_v})")

    # the pairing kernels' inputs on the path, captured from one call
    captured = {}

    def capture(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a):
            captured[name] = a
            return orig(*a)

        setattr(mod, name, wrapped)
        return mod, name, orig

    saved = [capture(g1, "g1_scalar_mul"),
             capture(pairing_device, "pairing_miller_eval"),
             capture(pairing_device, "pairing_final_exp")]
    pk.reset_launches()
    try:
        ks.check_proof_multi_batch(commit_v, proofs_v, xs_v, ys_v)
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    check(pk.LAUNCHES["pairing_lines"] == 0,
          "a second check recomputed the cached lines")
    # K-a's inputs as the path before the bilinear form gave them: G2 and
    # the digits of x_j^64
    ka_in = (g2.generator((n_cells,), dev),
             fr.scalar_windows_signed(fr.pow_static(
                 fr.from_int(xs_v, dev), l)))
    # the lines part on its path inputs (G2 and [s^64]_2) and on 5 lanes
    # of a lane's own G2 points (pairings_product_is_one's form), one of
    # them the encoding of infinity
    g2_pts = [host_ec.g2_generator(), ks._s2(l)]
    lines_in = (fp2.from_int([q[0] for q in g2_pts], dev),
                fp2.from_int([q[1] for q in g2_pts], dev))
    own_pts = [host_ec.g2_mul(host_ec.g2_generator(), 3 + 1000 * i)
               for i in range(4)] + [None]
    own_in = (fp2.from_int([(0, 0) if q is None else q[0] for q in own_pts],
                           dev),
              fp2.from_int([(0, 0) if q is None else q[1] for q in own_pts],
                           dev))
    own_lines = pk.pairing_lines(*own_in)

    def lanes(args, k):
        """A copy of the first k lanes of a kernel's arguments (lines held
        for all lanes stay one set)."""
        out = []
        for a in args:
            if isinstance(a, JacobianPoint):
                out.append(JacobianPoint(*(c[:k].clone() for c in a)))
            else:
                out.append(a[:k].clone())
        return out

    # The path's first 5 lanes, with the branches a point at infinity
    # takes (I - C - [x^l]pi is at infinity for a cell whose proof is
    # [x^-l](I - C)): K-a's lane 1 gets Z = 0; K-b's lane 1 gets pi at
    # infinity, lane 2 a1 at infinity in g1_add's all-zero encoding, lane
    # 3 [s^l]_2 flagged at infinity, lane 4 both a1 at infinity and the
    # flag, so that its Miller value is one; K-c takes the plain Miller
    # values of those lanes. The same lanes again on their own G2 points'
    # lines (lane 4's at infinity, flagged).
    edge_a = lanes(ka_in, 5)
    edge_a[0].z[1] = 0
    edge_b = lanes(captured["pairing_miller_eval"], 5)
    for c in edge_b[3]:
        c[1] = 0
    for c in edge_b[0]:
        c[2] = 0
        c[4] = 0
    edge_b[5][3] = True
    edge_b[5][4] = True
    edge_own = [edge_b[0], own_lines, edge_b[2], edge_b[3], own_lines,
                edge_b[5]]
    edge_c = [pk.pairing_miller_eval_plain(*edge_b)]
    edge_c_own = [pk.pairing_miller_eval_plain(*edge_own)]
    twins = {"g2_scalar_mul": (pk.g2_scalar_mul, pk.g2_scalar_mul_plain,
                               [edge_a]),
             "pairing_lines": (pk.pairing_lines, pk.pairing_lines_plain,
                               [lines_in, own_in]),
             "pairing_miller_eval": (pk.pairing_miller_eval,
                                     pk.pairing_miller_eval_plain,
                                     [edge_b, edge_own]),
             "pairing_final_exp": (pk.pairing_final_exp,
                                   pk.pairing_final_exp_plain,
                                   [edge_c, edge_c_own])}
    for name, (kern, plain, arg_sets) in twins.items():
        for a in arg_sets:
            got, want = kern(*a), plain(*a)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            check(same(got, want),
                  f"{name} differs from its plain version at 5 lanes with "
                  f"points at infinity")
            checks[name] = max(checks.get(name, 0), max_abs_err(got, want))
    # pairing_miller (lines, then evaluation) on the lanes' own points
    check(same(pk.pairing_miller(edge_b[0], *own_in, edge_b[5], edge_b[3],
                                 *own_in, edge_b[5]),
               pk.pairing_miller_plain(edge_b[0], *own_in, edge_b[5],
                                       edge_b[3], *own_in, edge_b[5])),
          "pairing_miller differs from its plain version on own lines")
    inf_a = g2.to_affine(JacobianPoint(*(c[1:2] for c in
                                         pk.g2_scalar_mul(*edge_a))))[2]
    check(bool(inf_a.all()), "K-a of a point at infinity is not infinity")
    for f_ in (edge_c[0], edge_c_own[0]):
        check(bool(pk.pairing_final_exp(f_)[1][4]),
              "the lane with both pairs at infinity is not one")
    log("K-a, K-b (lines and evaluation) and K-c equal their plain versions "
        "bit for bit at the path's first 5 lanes, with a G2 point at "
        "infinity (K-a), pi at infinity, a1 at infinity, [s^l]_2 flagged at "
        "infinity and both (K-b, K-c), on the fixed lines and on the lanes' "
        "own; the lines of G2 and [s^64]_2 and of 5 own points")

    # ---- 9. times ----
    def timed(fn, reps):
        return cuda_ms(fn, reps)

    def clocks() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()

    log(f"clocks before timing: {clocks()}")

    fk20_ms = timed(lambda: fkm.da_using_fk20_multi(coeffs), 3)
    path_ms = timed(lambda: blob_to_proofs(blob), 3)
    fft20_ms = timed(lambda: fft(fs20, x20), 3)
    log(f"[{card}] FK20 da_using_fk20_multi: {fk20_ms:.3f} ms = "
        f"{n2 // l / fk20_ms * 1e3:.1f} proofs/s; blob->proofs "
        f"{path_ms:.3f} ms")
    log(f"[{card}] Fr FFT 2^20: {fft20_ms:.3f} ms")

    ext_ms = timed(lambda: das_extend_interleaved(fs13, evens), 5)

    def producer_pr6(ev):
        """The producer path with the per-level extension route."""
        ext_ = stage_das(fs13, ev[None])[0]
        cf_ = fft(fs13, ext_, inverse=True)
        return (ext_, cf_, ks.commit_to_poly(cf_[:n]),
                fkm.fk20_multi_da_optimized(cf_))

    check(all(same(a_, b_) for a_, b_ in zip(producer_pr6(evens),
                                             producer(evens))),
          "the producer path differs on the per-level extension route")
    commit_ms = timed(lambda: ks.commit_to_poly(cf[:n]), 5)
    producer_ms = timed(lambda: producer(evens), 3)
    log(f"[{card}] producer path (extend, inverse FFT, commit, FK20): "
        f"{producer_ms:.3f} ms; das_extend_interleaved {ext_ms:.3f} ms; "
        f"commit_to_poly (fixed-base product + g1_sum) {commit_ms:.3f} ms")
    # the variable-base MSM over the same 4096 points (lin_comb_g1): the
    # window sums (multiples table, gather, g1_sum) and g1_horner alone
    wsums = msm.window_sums(crs_n, cf[:n])
    wsums_ms = timed(lambda: msm.window_sums(crs_n, cf[:n]), 3)
    horner_ms = timed(lambda: gk.g1_horner(wsums), 3)
    lin_comb_ms = timed(lambda: msm.lin_comb_g1(crs_n, cf[:n]), 3)
    log(f"[{card}] lin_comb_g1 at {n} points: {lin_comb_ms:.3f} ms; window "
        f"sums {wsums_ms:.3f} ms, g1_horner {horner_ms:.3f} ms")

    def trace(what, fn, call_ms, chrome_dir=None):
        """Device activity of one traced call of fn."""
        spans = device_events(fn, chrome_dir)
        busy_ms = busy_us(spans) / 1e3
        by_name = {}
        for name, s, e in spans:
            cnt, tot = by_name.get(name, (0, 0.0))
            by_name[name] = (cnt + 1, tot + (e - s) / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        prof = {"device_ops": len(spans), "busy_ms": busy_ms,
                "call_ms": call_ms,
                "idle_share": max(0.0, 1 - busy_ms / call_ms),
                "top": [{"name": k[:120], "count": c, "ms": t}
                        for k, (c, t) in top[:12]]}
        log(f"[{card}] {what} trace: {len(spans)} device ops, busy "
            f"{busy_ms:.3f} ms of {call_ms:.3f} ms "
            f"(idle share {prof['idle_share']:.3f})")
        for row in prof["top"][:8]:
            log(f"    {row['ms']:10.3f} ms {row['count']:6d}x "
                f"{row['name'][:90]}")
        return prof

    profile = trace("FK20", lambda: fkm.da_using_fk20_multi(coeffs), fk20_ms)
    ext_profile = trace("DAS extension",
                        lambda: das_extend_interleaved(fs13, evens), ext_ms)
    check(ext_profile["device_ops"] <= 3,
          f"the DAS extension's trace holds {ext_profile['device_ops']} "
          "device operations")
    commit_profile = trace("commit", lambda: ks.commit_to_poly(cf[:n]),
                           commit_ms)

    recover_ms = timed(lambda: recover_poly_from_samples(fs13, samples,
                                                         missing), 3)
    recover_to_proofs_ms = timed(lambda: reconstruct(samples), 2)
    fk20_single_ms = timed(lambda: fks.da_using_fk20(cf[:n]), 2)
    log(f"[{card}] recover_poly_from_samples (8192 values, 4096 missing): "
        f"{recover_ms:.3f} ms; recovery -> inverse FFT -> commit -> 128 "
        f"proofs {recover_to_proofs_ms:.3f} ms; FK20 single da_using_fk20 "
        f"({n2} proofs) {fk20_single_ms:.3f} ms; compute_proof_multi "
        f"(one call, wall) {proof_multi_s * 1e3:.3f} ms")
    recover_profile = trace(
        "recovery", lambda: recover_poly_from_samples(fs13, samples, missing),
        recover_ms)
    check(recover_profile["device_ops"] <= 400,
          f"the recovery trace holds {recover_profile['device_ops']} device "
          "operations")

    path_launches = {"setup": setup_launches, "proof": fk20_launches,
                     "producer": launches, "reconstruction": rec_launches,
                     "proof_api": api_launches,
                     "fk20_single": single_launches,
                     "verification": verify_launches}
    kernels = []

    def record(name, match, source, replaces, fn, plain_fn, nbytes,
               products, err, reps=5, chain=None, lat=None, per_call=1,
               shape=None):
        """A kernel's row of the kernels line, timed at the shape given;
        a second shape of a kernel already recorded goes into its row's
        `shapes`."""
        # the kernel against its plain version at the timed shape, the
        # plain version first: the Fr stages work in place
        ref, pms = once_ms(plain_fn)
        out = fn()
        check(same(out, ref),
              f"{name} differs from its plain version at the timed shape")
        err = max(err, max_abs_err(out, ref))
        # events, trace, events again: the two event timings bracket the
        # traced one, so a clock that ramps during the window shows
        call_ms = timed(fn, reps)
        dev_ms, caught = kernel_ms(fn, match, reps)
        call2_ms = timed(fn, reps)
        # a call of `per_call` launches: its device time is theirs
        ms = dev_ms * per_call
        b, by = bound_ms(nbytes, products)
        by_path = {p: c[name] for p, c in path_launches.items()}
        row = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b,
               "bound_by": by}
        first = next((k for k in kernels if k["name"] == name), None)
        if first is None:
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **row, "library_ms": None,
                "latency_ms": None if chain is None else
                chain * (lat or lat_ms), "shape": shape})
        else:
            first.setdefault("shapes", []).append({
                "shape": shape, **row, "call_ms": call2_ms,
                "latency_ms": None if chain is None else
                chain * (lat or lat_ms)})
        timing[name if first is None else f"{name} {shape}"] = {
            "device_ms": dev_ms, "traced_launches": caught, "reps": reps,
            "launches_a_call": per_call, "call_ms": [call_ms, call2_ms],
            "chain_products": chain}
        log(f"[{card}] {name}{'' if shape is None else f' ({shape})'}: "
            f"{ms:.4f} ms on the device ({caught} of {reps * per_call} "
            f"launches traced), {call_ms:.4f} then {call2_ms:.4f} ms "
            f"a call (plain {pms:.3f} ms, bound {b:.3g} ms by {by})")

    timing = {}

    FR = fr.SPEC
    # K1 at 8192 Fr lanes against the broadcast integer 1 (fr.from_mont
    # at Toeplitz part 2's shape; no path runs it there since the
    # recoding reduces its words itself)
    a = fr.from_int(random_fr_ints(rng, 64 * 128, r), dev)
    one = FR.words([1], dev)[0]
    nl = a.shape[0]
    record("mont_mul", "mont_mul_kernel", "kzg_tpu_torch/csrc/fr_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:324",
           lambda: fk.mont_mul(FR, a, one),
           lambda: fk.mont_mul_plain(FR, a, one),
           2 * 32 * nl + 32, nl * (2 * 8 * 8 + 8),
           max(checks["mont_mul_Fr"], checks["mont_mul_Fp"]))
    # fr_scale at the exit of the per-level DAS extension route: 4096
    # lanes
    c13 = fr.from_int(pow(n, -1, r), dev)
    x13 = blob
    record("fr_scale", "mont_mul_kernel", "kzg_tpu_torch/csrc/fr_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:658",
           lambda: fk.fr_scale(FR, x13, c13),
           lambda: fk.fr_scale_plain(FR, x13, c13),
           2 * 32 * n, n * (2 * 8 * 8 + 8), checks["fr_scale"])
    # K2: last stage of the batched (64, 128) Toeplitz-coefficient FFT
    xs = fr.from_int(random_fr_ints(rng, 64 * 128, r), dev).reshape(64, 128, 8)
    half = 64
    nbf = 64 * 64
    record("fr_butterfly_stage", "butterfly_stage_kernel",
           "kzg_tpu_torch/csrc/fr_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:514",
           lambda: fk.fr_butterfly_stage(FR, xs, fs13.expanded_roots_of_unity,
                                         6, fs13.max_width // 128),
           lambda: fk.fr_butterfly_stage_plain(
               FR, xs, fs13.expanded_roots_of_unity, 6,
               fs13.max_width // 128),
           nbf * (4 * 32) + half * 32, nbf * (2 * 8 * 8 + 8),
           max(checks["fr_butterfly_stage_0"], checks["fr_butterfly_stage_1"]))
    # the product's dependent latency: one K3 lane is one thread's chain
    # of Fp products (jac_to_proj 3, table 7 x 12, 63 x 4 doublings of 8,
    # 12 per nonzero digit, store 3), alone on the card
    one = JacobianPoint(*(c[3:4].contiguous() for c in base))
    d1l = fr.scalar_windows_signed(fr.from_int([r - 12345], dev))
    chain1 = 3 + 7 * 12 + 63 * 4 * 8 + 12 * int((d1l != 0).sum()) + 3
    lane_fn = (lambda: gk.g1_scalar_mul(one, d1l))
    lane_ms, _ = kernel_ms(lane_fn, "scalar_mul_kernel", 5)
    lat_ms = lane_ms / chain1
    log(f"[{card}] Fp product dependent latency: one K3 lane "
        f"{lane_ms:.4f} ms / {chain1} products = {lat_ms * 1e6:.1f} ns")

    def ladder_chain(dig, phi_rows: bool):
        """Products on the longest thread of a ladder launch: from the top
        nonzero window down, 4 doublings a window, 12 an addition (13 on
        the phi row)."""
        d = dig.reshape(dig.shape[0], -1, dig.shape[-1])
        nz = d != 0
        any_nz = nz.any(1)
        w = torch.arange(d.shape[-1], device=d.device)
        top = torch.where(any_nz, w, -1).max(-1).values.clamp(min=0)
        adds = nz[:, 0].sum(-1) * 12
        if phi_rows:
            adds = adds + nz[:, 1].sum(-1) * 13
        return int((top * 32 + adds).max())

    # K3 (old route of part 2) at the Toeplitz pointwise product, 64 x 128
    # lanes, and the fixed-base product that replaces it on the same lanes
    pts = JacobianPoint(*(c.reshape(-1, 12).contiguous()
                          for c in fkm.x_ext_fft_files))
    tbl = fkm.x_ext_fft_tables.reshape(-1, 64, 8, 36)
    n_pts = pts.x.shape[0]
    dig = fr.scalar_windows_signed(
        fr.from_int(random_fr_ints(rng, n_pts, r), dev))
    nnz = int((dig != 0).sum())
    muls3 = n_pts * (3 + 7 * 12 + 64 * 4 * 8 + 3) + 12 * nnz
    k3_bytes = n_pts * (6 * 48 + 64 * 4)
    turns = {}

    def in_turns(key, old_fn, new_fn, reps):
        """old, new, new, old with CUDA events: both means, in one run."""
        o1, n1, n2_, o2 = (timed(f, reps) for f in (old_fn, new_fn, new_fn,
                                                      old_fn))
        turns[key] = {"old_ms": [o1, o2], "new_ms": [n1, n2_]}
        log(f"[{card}] in turns, {key}: old {o1:.4f} / {o2:.4f} ms, new "
            f"{n1:.4f} / {n2_:.4f} ms")

    in_turns("K3 g1_scalar_mul vs g1_fixed_base_mul, 8192 lanes",
             lambda: gk.g1_scalar_mul(pts, dig),
             lambda: gk.g1_fixed_base_mul(tbl, dig), 3)

    # PR 4's commit route, kept here only to time it beside the new one:
    # the window sums as a tree of g1_add launches over the 4096 points,
    # then Horner as 315 dependent one-lane launches (252 g1_double, 63
    # g1_add)
    def pr4_horner(ws: JacobianPoint) -> JacobianPoint:
        acc = JacobianPoint(*(c[63] for c in ws))
        for j in range(62, -1, -1):
            for _ in range(4):
                acc = gk.g1_double(acc)
            acc = gk.g1_add(acc, JacobianPoint(*(c[j] for c in ws)))
        return acc

    def pr4_commit():
        return pr4_horner(tree_reduce(g1.ops_kernel,
                                      msm.window_points(crs_n, cf[:n])))

    check(same(g1.to_affine(pr4_commit()), g1.to_affine(commit)),
          "PR 4's commit route differs from the fixed-base commit")
    check(same(g1.to_affine(tree_reduce(g1.ops_kernel, part2)),
               g1.to_affine(gk.g1_sum(part2, 0))),
          "FK20's g1_add tree differs from g1_sum")
    in_turns("commit: PR 4 route (g1_add tree, 315-launch Horner) vs "
             "fixed-base product + g1_sum", pr4_commit,
             lambda: ks.commit_to_poly(cf[:n]), 3)
    in_turns("FK20 l-way sum, 128 x 64: 6 g1_add launches vs one g1_sum",
             lambda: tree_reduce(g1.ops_kernel, part2),
             lambda: gk.g1_sum(part2, 0), 10)
    record("g1_scalar_mul", "scalar_mul_kernel",
           "kzg_tpu_torch/csrc/g1_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:473",
           lambda: gk.g1_scalar_mul(pts, dig),
           lambda: gk.g1_scalar_mul_plain(pts, dig),
           k3_bytes, muls3 * 300, checks["g1_scalar_mul"], reps=3,
           chain=3 + 84 + ladder_chain(dig, False) + 3)
    # the fixed-base product's own work, given its tables: one 144-byte
    # table entry read and one addition (12 products) a nonzero digit,
    # the digits read, the Jacobian output (3 products) written
    fixed_chain = 12 * int((dig.reshape(-1, 8, 8) != 0).sum(-1).max()) \
        + 3 * 12 + 3
    record("g1_fixed_base_mul", "fixed_base_mul_kernel",
           "kzg_tpu_torch/csrc/g1_table_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:473",
           lambda: gk.g1_fixed_base_mul(tbl, dig),
           lambda: gk.g1_fixed_base_mul_plain(tbl, dig),
           nnz * 144 + n_pts * (64 * 4 + 3 * 48), (12 * nnz + 3 * n_pts) * 300,
           checks["g1_fixed_base_mul"], chain=fixed_chain)
    # beside it, the bound of K3's function (the TPU kernel's work: 8192
    # ladders of 64 windows), for comparison with the route it replaces
    kernels[-1]["function_bound_ms"] = bound_ms(k3_bytes, muls3 * 300)[0]

    # the G1 FFT at the path's 128 points: K4 at one radix-2 stage (64
    # lanes, the last), and the dense stage (one window_table and one
    # fft_stage launch) that replaces the 7 (8 inverse) K4 launches.
    # Both are held to the radix-2 transform's work: 7 x 64 GLV ladders.
    k2 = n2 // l
    h128 = JacobianPoint(*(c[0].contiguous() for c in fkm.x_ext_fft_files))
    radix2 = (2,) * (k2.bit_length() - 1)
    bf_stages = fft_mod._plan_host(13, k2, False, radix2)[0]
    _, d1n, d2n = bf_stages[-1]
    d1 = torch.from_numpy(d1n).to(dev)
    d2 = torch.from_numpy(d2n).to(dev)
    A = JacobianPoint(*(c[:k2 // 2].contiguous() for c in pts))
    B = JacobianPoint(*(c[k2 // 2:k2].contiguous() for c in pts))

    def bf_products(d1a, d2a):
        return d1a.shape[0] * (3 + 7 * 12 + 33 * 4 * 8 + 3 + 2 * 12
                               + 2 * 3) + 12 * int(np.count_nonzero(d1a)) \
            + 13 * int(np.count_nonzero(d2a))

    muls4 = bf_products(d1n, d2n)
    muls_fft = sum(bf_products(st[1], st[2]) for st in bf_stages)
    bf_chain = 3 + 84 + ladder_chain(torch.stack(
        (d1, d2), 1), True) + 3 + 2 * (12 + 3)
    in_turns("K4 radix-2 plan (7 launches) vs dense stage, 128-point FFT",
             lambda: fft_mod._fft_g1_core(h128, 13, False, radix2),
             lambda: fft_mod._fft_g1_core(h128, 13, False, (k2,)), 2)
    record("g1_glv_butterfly", "glv_butterfly_kernel",
           "kzg_tpu_torch/csrc/g1_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:526",
           lambda: gk.g1_glv_butterfly(A, B, d1, d2),
           lambda: gk.g1_glv_butterfly_plain(A, B, d1, d2),
           k2 // 2 * (12 * 48 + 2 * 33 * 4), muls4 * 300,
           checks["g1_glv_butterfly"], chain=bf_chain)
    dense = fft_mod._plan_device(13, k2, False, (k2,), dev)[0][0]
    _, _, src128, dst128, dig128 = dense
    flat128 = JacobianPoint(*(c.contiguous() for c in h128))
    tb128 = gk.g1_window_table(flat128, 1, src128, k2)
    record("g1_window_table", "window_table_kernel",
           "kzg_tpu_torch/csrc/g1_table_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:526",
           lambda: gk.g1_window_table(flat128, 1, src128, k2),
           lambda: gk.g1_window_table_plain(flat128, 1, src128, k2),
           k2 * (3 * 48 + 8 * 144 + 4), k2 * (3 + 7 * 12) * 300,
           checks["g1_window_table"], chain=3 + 7 * 12)
    stage_digits = dig128.reshape(-1, 2, 33)
    record("g1_fft_stage", "fft_stage_kernel",
           "kzg_tpu_torch/csrc/g1_fft_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:526",
           lambda: gk.g1_fft_stage(tb128, dig128, dst128, k2, k2),
           lambda: gk.g1_fft_stage_plain(tb128, dig128, dst128, k2, k2),
           k2 * 2 * 3 * 48, muls_fft * 300, checks["g1_fft_stage"],
           reps=3, chain=ladder_chain(stage_digits, True) + 7 * 12 + 3)

    # the 8192-point G1 FFT (FK20 single's transforms) under radix plans:
    # the whole transform with CUDA events, each launch from a trace
    h8k = JacobianPoint(*(c.contiguous() for c in fks.x_ext_fft))
    plans = {}
    for plan in ((2,) * (n2.bit_length() - 1), fft_mod.mixed_plan(n2, 4),
                 fft_mod.mixed_plan(n2, 8), fft_mod.mixed_plan(n2, 16),
                 fft_mod.mixed_plan(n2, 32), fft_mod.mixed_plan(n2, 128)):
        fn = (lambda p=plan: fft_mod._fft_g1_core(h8k, 13, False, p))
        total = timed(fn, 1)
        spans = [(k, (e - s_) / 1e3) for nm, s_, e in device_events(fn)
                 for k in ("glv_butterfly", "window_table", "fft_stage")
                 if f"{k}_kernel" in nm]
        plans[str(plan)] = {"ms": total, "launches": [
            {"kernel": k, "ms": t} for k, t in spans]}
        log(f"[{card}] G1 FFT 8192 plan {plan}: {total:.3f} ms; launches "
            + ", ".join(f"{k} {t:.3f}" for k, t in spans))
    log(f"default plan at 8192: {fft_mod.default_plan(n2)}")

    # g1_add at 2^17 lanes, PR 2-4's first MSM tree level (the edge lanes
    # above; a lane's products are counted by the branch it takes)
    record("g1_add", "g1_add_kernel",
           "kzg_tpu_torch/csrc/g1_point_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:373",
           lambda: gk.g1_add(P, Q), lambda: gk.g1_add_plain(P, Q),
           n5 * 9 * 48, add_products * 300, checks["g1_add"], chain=16)
    # g1_double at PR 2-4's Horner width: one lane per commitment
    P1 = JacobianPoint(*(c[7:8] for c in P))
    record("g1_double", "g1_double_kernel",
           "kzg_tpu_torch/csrc/g1_point_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:394",
           lambda: gk.g1_double(P1), lambda: gk.g1_double_plain(P1),
           6 * 48, 7 * 300, checks["g1_double"], reps=20,
           chain=7)

    def sum_chain(n_pts: int) -> int:
        """Products on thread 0's chain of a g1_sum call over rows of
        n_pts: per pass a conversion, its run's additions and the tree
        levels whose partner holds items, the Jacobian store."""
        run, threads = gk.SUM_RUN, gk.SUM_THREADS
        total = 0
        while True:
            block = min(n_pts, run * threads)
            adds = min(run, block) - 1
            adds += sum(1 for s in (16, 8, 4, 2, 1) if s * run < block)
            adds += sum(1 for s in range(threads // 64, 0, -1)
                        if s * 32 * run < block)
            total += 3 + 12 * adds + 3
            if n_pts <= run * threads:
                return total
            n_pts = -(-n_pts // (run * threads))

    def sum_bound(rows_: int, n_pts: int):
        """(bound, by) of R rows of N points: each point read once (144
        bytes), each sum written, R (N - 1) additions of 12 products."""
        return bound_ms(rows_ * (n_pts + 1) * 144,
                        rows_ * (n_pts - 1) * 12 * 300)

    # g1_sum at FK20's l-way sum, 128 rows of 64 (part 2's output, axis 0)
    record("g1_sum", "g1_sum_kernel", "kzg_tpu_torch/csrc/g1_sum_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:373",
           lambda: gk.g1_sum(part2, 0), lambda: gk.g1_sum_plain(part2, 0),
           128 * 65 * 144, 128 * 63 * 12 * 300, checks["g1_sum"], reps=10,
           chain=sum_chain(64))
    kernels[-1]["tree_latency_bound_ms"] = 6 * 12 * lat_ms
    # and at the commitment's 1 x 4096 and the MSM's 64 x 4096 (two
    # launches each: the second sums the block partials), on the path's
    # own inputs
    commit_parts = gk.g1_fixed_base_mul(crs_tables[:n],
                                        fr.scalar_windows_signed(cf[:n]))
    wpts_path = msm.window_points(crs_n, cf[:n])
    sum_shapes = {}
    for key, (pts_, dim, rows_, n_pts) in {
            f"commit 1 x {n}": (JacobianPoint(*(c[None] for c in
                                                commit_parts)), -1, 1, n),
            f"MSM 64 x {n}": (wpts_path, 0, 64, n)}.items():
        got = gk.g1_sum(pts_, dim)
        check(same(got, gk.g1_sum_plain(pts_, dim)),
              f"g1_sum {key} differs from its plain version")
        fn = (lambda p_=pts_, d_=dim: gk.g1_sum(p_, d_))
        call_ms = timed(fn, 5)
        dev_ms, caught = kernel_ms(fn, "g1_sum_kernel", 5)
        b, by = sum_bound(rows_, n_pts)
        sum_shapes[key] = {
            "call_ms": call_ms, "device_ms_per_launch": dev_ms,
            "traced_launches": caught, "bound_ms": b, "bound_by": by,
            "chain_products": sum_chain(n_pts),
            "latency_ms": sum_chain(n_pts) * lat_ms,
            "tree_latency_bound_ms": (n_pts - 1).bit_length() * 12 * lat_ms}
        log(f"[{card}] g1_sum {key}: {call_ms:.4f} ms a call, {dev_ms} ms "
            f"a launch on the device ({caught} traced); bound "
            f"{b:.3g} ms by {by}; chain {sum_chain(n_pts)} products")
    # g1_horner on the commitment's 64 window sums. The function needs
    # 63 x (4 doublings + 1 addition): 7 products a Jacobian doubling
    # (dbl-2009-l, as g1_double above) and 12 an addition, 2,520 in all.
    # The kernel's own chain is longer: 8 products an RCB doubling, with
    # the first window's conversion and the Jacobian store (2,778).
    ws1 = JacobianPoint(*(c[None] for c in wsums))
    horner_products = 63 * (4 * 7 + 12)
    record("g1_horner", "g1_horner_kernel",
           "kzg_tpu_torch/csrc/g1_sum_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:394",
           lambda: gk.g1_horner(ws1), lambda: gk.g1_horner_plain(ws1),
           65 * 144, horner_products * 300,
           checks["g1_horner"], reps=3, chain=3 + 63 * (4 * 8 + 12) + 3)
    kernels[-1]["function_latency_bound_ms"] = horner_products * lat_ms
    # fr_dif_stage at the first down-sweep level of the per-level
    # extension route: 2048 butterflies over one row of 4096
    x1 = xd[:1].clone()
    record("fr_dif_stage", "dif_stage_kernel",
           "kzg_tpu_torch/csrc/fr_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:567",
           lambda: fk.fr_dif_stage(FR, x1, fs13.reverse_roots_of_unity, 11,
                                   2),
           lambda: fk.fr_dif_stage_plain(FR, x1, fs13.reverse_roots_of_unity,
                                         11, 2),
           2048 * (4 * 32 + 32), 2048 * (2 * 8 * 8 + 8),
           checks["fr_dif_stage"])
    # fr_signed_windows at part 2's 8192 scalars (the path's Montgomery
    # words) and at 9 x 4096: 32 bytes read and 256 written a scalar; the
    # REDC does 8 x 8 word products and 8 digit products a scalar. It
    # replaces plain tensor code of kzg_tpu, not a Pallas kernel
    for nsw in (8192, 9 * 4096):
        words = sw_in[nsw]
        record("fr_signed_windows", "signed_windows_kernel",
               "kzg_tpu_torch/csrc/fr_kernels.cu",
               "kzg_tpu/field/fr.py:109-130",
               lambda w=words: fk.fr_signed_windows(w),
               lambda w=words: fk.fr_signed_windows_plain(w),
               nsw * (32 + 256), nsw * 72, checks["fr_signed_windows"],
               shape=f"{nsw} Montgomery scalars")
    # butterfly, on no path: at phase 2's 2^16 lanes, then at 2^20, where
    # bytes bound it, Fr and Fp; per-lane twiddles: a, b, tw read,
    # hi and lo written, one product a lane
    for src in (bf_in, bf20):
        for fname, (ba, bb, bt) in src.items():
            spec = fr.SPEC if fname == "Fr" else fp.SPEC
            N, nbl = spec.n_words, ba.shape[0]
            record("butterfly", "butterfly_stream_kernel",
                   "kzg_tpu_torch/csrc/fr_kernels.cu",
                   "kzg_tpu/field/pallas_kernels.py:344",
                   functools.partial(fk.butterfly, spec, ba, bb, bt),
                   functools.partial(fk.butterfly_plain, spec, ba, bb, bt),
                   5 * 4 * N * nbl, nbl * (2 * N * N + N),
                   max(checks["butterfly_Fr"], checks["butterfly_Fp"]),
                   shape=f"{fname}, {nbl} lanes")

    # ---- the routes of K1 and K2: old and new in turns, then each kernel
    # The Fr product's dependent latency: one lane's Fermat ladder is one
    # thread's chain of (bits - 1) squarings and (ones - 1) multiplies
    e_inv = r - 2
    ladder = (e_inv.bit_length() - 1) + (bin(e_inv).count("1") - 1)
    a1 = inv_in[5:6].clone()
    pow1_fn = (lambda: fk.fr_pow(FR, a1, e_inv))
    pow1_ms, _ = kernel_ms(pow1_fn, "pow_kernel", 5)
    fr_lat_ms = pow1_ms / ladder
    log(f"[{card}] Fr product dependent latency: a one-lane ladder "
        f"{pow1_ms:.4f} ms / {ladder} products = {fr_lat_ms * 1e6:.1f} ns")
    k1 = functools.partial(fk.mont_mul, FR)

    def scan_batch_inv(a_):
        """The earlier fr.batch_inv, kept here only to time it beside the
        kernel: prefix and suffix scans of K1 launches, the total's Fermat
        ladder as one-lane K1 launches."""
        one_ = FR.words([FR.one_mont], dev)
        zero_ = limbs.is_zero(a_)
        safe = limbs.select(zero_, one_, a_)
        pre = limbs.prefix_products(k1, safe)
        suf = limbs.prefix_products(k1, safe, reverse=True)
        tinv = limbs.pow_static(FR, k1, pre[-1], e_inv)
        out = k1(k1(torch.cat((one_, pre[:-1])), torch.cat((suf[1:], one_))),
                 tinv)
        return limbs.select(zero_, torch.zeros_like(out), out)

    def loop_leaves(idx_, valid_):
        """The earlier leaf build, kept here only to time it: 64 steps of a
        plain-engine add, a K1 product, a concatenation and a select."""
        roots_ = fs13.expanded_roots_of_unity
        ii = torch.as_tensor(idx_.reshape(-1), dtype=torch.long, device=dev)
        negr = limbs.neg(FR, roots_[ii]).reshape(idx_.shape + (8,))
        poly = fr.zeros((idx_.shape[0], fk.LEAF_WIDTH), dev)
        poly[:, 0] = fr.from_int(1, dev)
        for s_ in range(int(valid_.sum(1).max())):
            shifted = torch.cat((torch.zeros_like(poly[:, :1]),
                                 poly[:, :-1]), dim=1)
            cand = limbs.add(FR, shifted, k1(poly, negr[:, s_, None, :]))
            poly = cand if valid_[:, s_].all() else limbs.select(
                torch.as_tensor(valid_[:, s_, None], device=dev), cand, poly)
        return poly

    roots13 = fs13.expanded_roots_of_unity
    lidx, lvalid = leaves_in
    for key, old_fn, new_fn, reps in (
            ("Fr FFT 1 x 8192: K2 one launch a stage vs fr_fft_block",
             lambda: stage_fft(fft_in, roots13, 8192),
             lambda: fk.fr_fft_block(FR, fft_in, roots13, 8192), 10),
            ("Fr FFT 2^20: K2 one launch a stage vs fr_fft_block",
             lambda: stage_fft(x20, fs20.expanded_roots_of_unity, 1 << 20),
             lambda: fft(fs20, x20), 3),
            ("Fermat ladder, one lane: K1 a product vs fr_pow",
             lambda: limbs.pow_static(FR, k1, a1, e_inv), pow1_fn, 2),
            ("batch inversion, 8192 lanes: K1 scans and ladder vs "
             "fr_batch_inv", lambda: scan_batch_inv(inv_in),
             lambda: fk.fr_batch_inv(FR, inv_in), 2),
            ("zero-polynomial leaves, 64 x 64 factors: 64-step loop vs "
             "fr_zero_poly_leaves", lambda: loop_leaves(lidx, lvalid),
             lambda: fk.fr_zero_poly_leaves(FR, roots13, lidx, lvalid), 2),
            *((f"DAS extension {b_} x 4096, interleaved: the per-level "
               "route vs fr_das_block",
               lambda b_=b_: stage_das(fs13, das_in[b_]),
               lambda b_=b_: fk.fr_das_block(FR, das_in[b_], *das_tables,
                                             8192, True), 10)
              for b_ in (1, 9))):
        old_out, new_out = old_fn(), new_fn()
        check(same(old_out.reshape(new_out.shape), new_out),
              f"{key}: the old route differs from the new")
        in_turns(key, old_fn, new_fn, reps)
    in_turns("producer path, 1 blob: the per-level extension route vs "
             "fr_das_block", lambda: producer_pr6(evens),
             lambda: producer(evens), 5)

    # fr_add_sub at the proof API's quotient numerator: 4096 Fr lanes
    # less one broadcast element; bytes only
    ev4 = cf[:n]
    y1 = inv_in[7]
    record("fr_add_sub", "add_sub_kernel",
           "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/field/fr.py:34-44",
           lambda: fk.fr_add_sub(FR, "sub", ev4, y1),
           lambda: fk.fr_add_sub_plain(FR, "sub", ev4, y1),
           2 * 32 * n + 32, 0, checks["fr_add_sub"], reps=20)
    # fr_pow at the quotient's denominators: 4096 lanes of r - 2
    record("fr_pow", "pow_kernel", "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:324",
           lambda: fk.fr_pow(FR, ev4, e_inv),
           lambda: fk.fr_pow_plain(FR, ev4, e_inv),
           2 * 32 * n, n * ladder * (2 * 8 * 8 + 8), checks["fr_pow"],
           reps=3, chain=ladder, lat=fr_lat_ms)
    kernels[-1]["lane_ms"] = pow1_ms
    # fr_batch_inv at the recovery's 8192 lanes: the trick's 3 (n - 1)
    # products and one ladder; its chain is thread 0's: a chunk, the
    # scan's 8 levels, the ladder, 2 products, the back pass's chunk
    ch, _ = fk.inv_chunking(n2)
    record("fr_batch_inv", "batch_inv_kernel",
           "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:324",
           lambda: fk.fr_batch_inv(FR, inv_in),
           lambda: fk.fr_batch_inv_plain(FR, inv_in),
           2 * 32 * n2, (3 * (n2 - 1) + ladder) * (2 * 8 * 8 + 8),
           checks["fr_batch_inv"], chain=ch + 8 + ladder + 2 + ch,
           lat=fr_lat_ms)
    # fr_fft_block at the recovery's 1 x 8192 forward transform: values
    # read and written once, the 4096 twiddles of the last stage (the
    # earlier stages' are among them) read once, (n/2)(log2 n - 1)
    # products; a thread's chain is one butterfly a stage
    plan13 = fk.fft_plan(13)
    record("fr_fft_block", "fft_block_kernel",
           "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:514",
           lambda: fk.fr_fft_block(FR, fft_in, roots13, 8192),
           lambda: fk.fr_fft_block_plain(FR, fft_in, roots13, 8192),
           2 * 32 * n2 + 32 * n2 // 2, n2 // 2 * 12 * (2 * 8 * 8 + 8),
           checks["fr_fft_block"], reps=10, chain=13 - 1, lat=fr_lat_ms,
           per_call=len(plan13))
    # and at 2^20 (2 passes): events around the whole call
    fft20_bytes = 2 * 32 * (1 << 20) + 32 * (1 << 19)
    fft20_products = (1 << 19) * 19
    fft20_bound = bound_ms(fft20_bytes, fft20_products * (2 * 8 * 8 + 8))
    fft(fs20, x20)
    fft20_passes = [(e - s_) / 1e3 for nm, s_, e in device_events(
        lambda: fft(fs20, x20)) if "fft_block_kernel" in nm]
    kernels[-1]["at_2_20"] = {"pass_ms": fft20_passes,
                              "launches": fft20_launches,
                              "call_ms": timed(lambda: fft(fs20, x20), 5),
                              "bound_ms": fft20_bound[0],
                              "bound_by": fft20_bound[1]}
    # fr_das_block at the producer's extension, 1 x 4096 interleaved: the
    # evens read and the 8192 values written once, the twiddles once (the
    # down-sweep's are the 2048 of its widest level, the up-sweep's odd
    # multiples are new at every level: 4095), 24 levels of 2048 products
    # and 4096 scales; a thread's chain is one butterfly a level and the
    # scale. Also at 9 blobs, per launch from a trace.
    das_bytes = 32 * (4096 + 8192 + 2048 + 4095)
    das_products = 24 * 2048 + 4096
    record("fr_das_block", "das_block_kernel",
           "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/field/pallas_kernels.py:567",
           lambda: fk.fr_das_block(FR, das_in[1], *das_tables, 8192, True),
           lambda: fk.fr_das_block_plain(FR, das_in[1], *das_tables, 8192,
                                         True),
           das_bytes, das_products * (2 * 8 * 8 + 8),
           max(checks["fr_das_block"], checks["das_extension"]), reps=10,
           chain=2 * 12 + 1, lat=fr_lat_ms,
           per_call=len(fk.das_plan(12)))
    kernels[-1]["also_replaces"] = ["kzg_tpu/field/pallas_kernels.py:658",
                                    "kzg_tpu/field/pallas_kernels.py:514"]
    fn = (lambda: fk.fr_das_block(FR, das_in[9], *das_tables, 8192, True))
    launch_ms, caught = kernel_ms(fn, "das_block_kernel", 10)
    passes = len(fk.das_plan(12))
    b, by = bound_ms(9 * das_bytes, 9 * das_products * (2 * 8 * 8 + 8))
    key = "9 x 4096"
    das_variants = {key: {
        "device_ms": launch_ms * passes,
        "traced_launches": caught, "passes": passes,
        "call_ms": timed(fn, 10), "bound_ms": b, "bound_by": by}}
    log(f"[{card}] fr_das_block {key}: {passes} passes, "
        f"{das_variants[key]['device_ms']} ms on the device ({caught} "
        f"of {10 * passes} launches traced), "
        f"{das_variants[key]['call_ms']:.4f} ms a call, bound "
        f"{b:.3g} ms by {by}")
    # where the default plan's device time goes at 1 x 4096: each pass
    # launched alone through the C entry point, on the wrapper's buffers,
    # and traced (a trace that misses a launch then leaves the others'
    # mean right)
    route_lib = build.library("fr_route_kernels")
    x_1 = das_in[1]
    odds_1 = fk.fr_das_block(FR, x_1, *das_tables, 8192)
    out_1 = torch.empty((1, 8192, 8), dtype=torch.int32, device=dev)
    inv_n = fk._host_words(FR.to_mont_int(pow(4096, -1, r)), fk.FR_WORDS)
    plan12 = fk.das_plan(12)
    per_pass = {}
    for p_, (lo_, kk_, sw_) in enumerate(plan12):
        last = p_ == len(plan12) - 1

        def one_pass(lo_=lo_, kk_=kk_, sw_=sw_, last=last, first=p_ == 0):
            build.check(route_lib.kzg_fr_das_block(
                (x_1 if first else odds_1).data_ptr(),
                (out_1 if last else odds_1).data_ptr(),
                x_1.data_ptr() if last else None,
                das_tables[0].data_ptr(), das_tables[1].data_ptr(), 12, lo_,
                kk_, 13, sw_, 1, ctypes.addressof(inv_n) if last else None,
                fk.stream_of(x_1)), "fr_das_block")

        per_pass[f"lo {lo_}, {kk_} levels, sweeps {sw_}"] = kernel_ms(
            one_pass, "das_block_kernel", 10)[0]
    das_variants["1 x 4096, device ms a pass"] = per_pass
    log(f"[{card}] fr_das_block 1 x 4096, device ms a pass: {per_pass}")
    kernels[-1]["variants"] = das_variants
    # fr_zero_poly_leaves at the recovery's 64 full leaves: the factor
    # indices, 4096 roots and 64 x 128 coefficients moved once; step s of
    # a leaf needs s + 1 products
    record("fr_zero_poly_leaves", "zero_poly_leaves_kernel",
           "kzg_tpu_torch/csrc/fr_route_kernels.cu",
           "kzg_tpu/das/zero_poly.py:34-51",
           lambda: fk.fr_zero_poly_leaves(FR, roots13, lidx, lvalid),
           lambda: fk.fr_zero_poly_leaves_plain(FR, roots13, lidx, lvalid),
           64 * 64 * 4 + 4096 * 32 + 64 * 128 * 32,
           64 * (64 * 65 // 2) * (2 * 8 * 8 + 8),
           checks["fr_zero_poly_leaves"], chain=64, lat=fr_lat_ms)

    # the verification path: the batched check of the 128 cells, timed and
    # traced, and its three pairing kernels at the path's 128 lanes
    def verify():
        return ks.check_proof_multi_batch(commit_v, proofs_v, xs_v, ys_v)

    verify_ms = timed(verify, 2)
    verify_profile = trace("verification", verify, verify_ms)
    log(f"[{card}] check_proof_multi_batch ({n_cells} cells): "
        f"{verify_ms:.3f} ms = {verify_ms / n_cells:.4f} ms a cell")
    fp_words = 2 * 12 * 12 + 12       # word multiply-adds of an Fp product
    # K-c's one inverse: its products on one thread; the Fp inverse inside
    # is a binary extended GCD (shifts and subtractions, uncounted) and one
    # product
    f12_inv_chain = 109 + 1
    src_p = "kzg_tpu_torch/csrc/pairing_kernels.cu"
    # K3 on the path: [x_j^64]pi_j at its 128 lanes
    k3v = captured["g1_scalar_mul"]
    nz3 = int((k3v[1] != 0).sum())
    record("g1_scalar_mul", "scalar_mul_kernel",
           "kzg_tpu_torch/csrc/g1_kernels.cu",
           "kzg_tpu/curve/pallas_g1.py:473",
           lambda: gk.g1_scalar_mul(*k3v),
           lambda: gk.g1_scalar_mul_plain(*k3v),
           n_cells * (6 * 48 + 64 * 4),
           (n_cells * (3 + 7 * 12 + 64 * 4 * 8 + 3) + 12 * nz3) * 300,
           checks["g1_scalar_mul"], reps=3,
           chain=3 + 84 + ladder_chain(k3v[1], False) + 3,
           shape=f"{n_cells} lanes, [x^64]pi (verification)")
    # K-a, on no path: [x_j^64]_2 at the 128 lanes the path gave it before
    # the bilinear form
    dig_a = ka_in[1]
    nz = dig_a != 0
    top = torch.where(nz, torch.arange(dig_a.shape[-1], device=dev),
                      -1).max(-1).values.clamp(min=0)
    chains_a = 8 + 7 * 36 + top * 4 * 22 + nz.sum(-1) * 36 + 8
    record("g2_scalar_mul", "g2_scalar_mul_kernel", src_p,
           "kzg_tpu/kzg/settings.py:60-66",
           lambda: tuple(pk.g2_scalar_mul(*ka_in)),
           lambda: tuple(pk.g2_scalar_mul_plain(*ka_in)),
           n_cells * (288 + 256 + 288), int(chains_a.sum()) * fp_words,
           checks["g2_scalar_mul"], reps=3, chain=int(chains_a.max()),
           shape=f"{n_cells} lanes")

    def rounds(k, g):
        """Product latencies of k independent products on g threads."""
        return -(-k // g)

    warp = 32                # threads a lane of K-b's evaluation and K-c

    # K-b's lines part: G2 and [s^64]_2, one thread a point: 27 products a
    # doubling, 35 an addition
    lines_chain = 63 * 27 + 5 * 35
    record("pairing_lines", "pairing_lines_kernel", src_p,
           "kzg_tpu/curve/pairing_device.py:97-205",
           lambda: pk.pairing_lines(*lines_in),
           lambda: pk.pairing_lines_plain(*lines_in),
           2 * 2 * 96 + 2 * pk.N_LINES * 288, 2 * lines_chain * fp_words,
           checks["pairing_lines"], reps=3, chain=lines_chain,
           shape="2 points (G2, [s^64]_2)")
    # K-b's evaluation at the path's 128 lanes on the fixed lines: Z^3, X Z
    # (6 products), then a squaring of f (36) and the lines at P (12) a
    # step, a sparse product (39) a line of an active pair; the longest
    # thread does ceil(k / threads) of each tier's k products
    mill = captured["pairing_miller_eval"]
    active = 2 - (fp.is_zero(mill[0].z) | mill[2].bool()).long() \
        - (fp.is_zero(mill[3].z) | mill[5].bool()).long()
    eval_products = int((6 + 63 * 36 + 68 * 12 + 68 * 39 * active).sum())
    amax = int(active.max())
    record("pairing_miller_eval", "pairing_miller_eval_kernel", src_p,
           "kzg_tpu/curve/pairing_device.py:97-205",
           lambda: pk.pairing_miller_eval(*mill),
           lambda: pk.pairing_miller_eval_plain(*mill),
           n_cells * (2 * 3 * 48 + 2 * 4 + 576) + 2 * pk.N_LINES * 288,
           eval_products * fp_words, checks["pairing_miller_eval"], reps=3,
           chain=2 + 63 * (rounds(36, warp) + rounds(12, warp))
           + 5 * rounds(12, warp) + 68 * amax * rounds(39, warp),
           shape=f"{n_cells} lanes, a warp a lane")
    # K-c: the inverse on one thread (f12_inv), then Fp12 products (54),
    # Frobenius maps (18) and the hard part's 314 cyclotomic squares (18)
    # and 52 products on the group
    fexp_in = captured["pairing_final_exp"][0]
    fexp_products = (f12_inv_chain + 2 * 54 + 18 + 314 * 18 + 52 * 54
                     + 2 * 18)
    record("pairing_final_exp", "pairing_final_exp_kernel", src_p,
           "kzg_tpu/curve/pairing_device.py:252-312",
           lambda: pk.pairing_final_exp(fexp_in),
           lambda: pk.pairing_final_exp_plain(fexp_in),
           n_cells * (576 + 576 + 4) + 3 * 576,
           n_cells * fexp_products * fp_words, checks["pairing_final_exp"],
           reps=3, chain=f12_inv_chain + 2 * rounds(54, warp)
           + rounds(18, warp) + 316 * rounds(18, warp)
           + 52 * rounds(54, warp), shape=f"{n_cells} lanes, a warp a lane")

    # ---- 10-13. the eth API, the generic G1 FFT, persistence, the
    # examples: after the kernel rows and the verification trace, which
    # so run as early in the process as before these phases existed
    # (torch.profiler loses more of a trace's device records the older
    # the process is); their launches join the kernel rows' counts ----
    kmods = (fk, gk, pk)
    eth_res, eth_setup_launches, eth_launches = eth_phase(
        dev, card, rng, kmods, plain_path, trace)
    fft_generic_res, fft_generic_launches = fft_g1_generic_phase(
        dev, card, rng, kmods, fs13)
    persist_res, persist_launches = persistence_phase(
        dev, card, kmods, ks, fkm, coeffs, proofs)
    examples_res = examples_phase(card)
    # ---- 14. the sharded paths, after every trace ----
    sharded_res, sharded_launches = sharded_phase(card)
    late = {"eth_setup": eth_setup_launches, "eth": eth_launches,
            "fft_g1_generic": fft_generic_launches,
            "persistence": persist_launches}
    path_launches.update(late)
    for row in kernels:
        row["launches_by_path"].update(
            {p: c[row["name"]] for p, c in late.items()})
        # one call of each sharded path, summed over the ranks and D
        row["launches_by_path"]["sharded"] = sharded_launches.get(
            row["name"], 0)
        row["launches"] = sum(row["launches_by_path"].values())
    # ---- 15. the field-chain experiments, last ----
    exp_res, exp_rows, exp_launches = exp_field_phase(dev, card)
    add_path(kernels, path_launches, "exp_field", exp_launches)
    kernels.extend(exp_rows)
    # ---- 16. the product-body experiments, last ----
    chain_res, chain_rows, chain_launches = exp_chain_phase(
        dev, card, ptxas, exp_res)
    add_path(kernels, path_launches, "exp_chain", chain_launches)
    kernels.extend(chain_rows)
    # ---- 17. the point-op experiments, last ----
    point_res, point_rows, point_launches = exp_point_phase(
        dev, card, ptxas, exp_res, chain_res)
    add_path(kernels, path_launches, "exp_point", point_launches)
    merge_rows(kernels, point_rows)

    log(f"clocks after timing: {clocks()}")
    result = {"card": card, "kind": kind, "fk20_ms": fk20_ms,
              "proofs_per_s": n2 // l / fk20_ms * 1e3,
              "blob_to_proofs_ms": path_ms,
              "fft_2_20_ms": fft20_ms, "crs_s": crs_s, "setup_s": setup_s,
              "producer_ms": producer_ms, "das_extend_ms": ext_ms,
              "commit_ms": commit_ms, "lin_comb_g1_ms": lin_comb_ms,
              "window_sums_ms": wsums_ms, "horner_ms": horner_ms,
              "crs_table_s": crs_table_s, "crs_table_bytes": crs_table_bytes,
              "crs_table_peak_bytes": crs_table_peak,
              "plain_crs_table_s": plain_crs_table_s,
              "g1_sum_shapes": sum_shapes, "recover_ms": recover_ms,
              "recover_to_proofs_ms": recover_to_proofs_ms,
              "fk20_single_ms": fk20_single_ms,
              "fk20_single_setup_s": single_setup_s, "build_s": build_s,
              "ptxas": ptxas, "fixed_base_table_s": table_s,
              "fixed_base_table_bytes": table_bytes,
              "fixed_base_table_peak_bytes": table_peak,
              "fp_product_latency_ms": lat_ms, "in_turns": turns,
              "g1_fft_8192_plans": plans,
              "proof_multi_s": proof_multi_s, "legacy_1024_s": legacy_s,
              "fft_2_20_launches": fft20_launches,
              "fft_8192_launches": fft8192_launches,
              "fr_product_latency_ms": fr_lat_ms,
              "recovery_launches": recovery_launches,
              "recovery_one_lane_k1": one_lane_k1,
              "launches": path_launches, "kernels": kernels,
              "kernel_timing": timing, "fk20_profile": profile,
              "commit_profile": commit_profile,
              "das_extension_profile": ext_profile,
              "recover_profile": recover_profile,
              "verify_ms": verify_ms, "verify_ms_a_cell": verify_ms / n_cells,
              "verify_first_s": verify_first_s,
              "decompress_129_s": decompress_s,
              "verify_profile": verify_profile, "eth": eth_res,
              "fft_g1_generic": fft_generic_res,
              "persistence": persist_res, "examples": examples_res,
              "sharded": sharded_res, "exp_field": exp_res,
              "exp_chain": chain_res, "exp_point": point_res}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
