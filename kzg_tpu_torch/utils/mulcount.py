"""Analytic field-multiply counts of kzg_tpu's pipelines, a copy of
kzg_tpu/utils/mulcount.py (pure host arithmetic).

The counts model the JAX package's kernels: Fr rows count its 17-limb
lazy-domain multiplies (ntt/fft_fr.py: stages 2..log2(n) multiply n/2
lanes each, stage 1 is mul-free, the exit scale one more per lane); G1
rows its 25-limb lazy Fp multiplies in the fused GLV ladder kernels
(curve/pallas_g1.py), from the per-formula costs RCB15 proj_add = 12M and
proj_double = 8M. They are counts of the operations each pipeline
issues, per whole op, exact except where marked ~ (batch_inv's scans,
counted at 2 muls a lane a scan). They are not the port's counts: the
port's kernels (csrc/) run other formulas on 32-bit words, and
chip_smoke.py computes their work from each run's inputs.
"""

from __future__ import annotations

# --- Fr pipeline counts (17-limb lazy muls) -------------------------------


def fft_fr(n: int) -> int:
    """Lazy pipeline: stages 2..log2(n) at n/2 muls each + n exit muls."""
    s = n.bit_length() - 1
    return (s - 1) * (n // 2) + n


def das_extension(n: int) -> int:
    """IFFT(n) + n coset muls (one mont_mul kernel pass) + FFT(n)."""
    return 2 * fft_fr(n) + n


def zero_poly(g: int, length: int, leaf_width: int = 128,
              leaf_factors: int = 64) -> int:
    """Leaf scan (leaf_factors steps x g*leaf_width lanes) + product tree
    (2 forward FFTs + pointwise mul + 1 inverse FFT per level) + final
    forward FFT. Mirrors das/zero_poly.zero_poly_graph's loop."""
    total = leaf_factors * g * leaf_width
    width, cnt = leaf_width, g
    while cnt > 1:
        target = min(2 * width, length)
        total += 3 * (cnt // 2) * fft_fr(target) + (cnt // 2) * target
        width = target
        cnt //= 2
    total += fft_fr(length)
    return total


def batch_inv(n: int) -> int:
    """~2 muls/lane for each of the two associative scans + one Fermat
    ladder (~380 muls) on the full width (limbs.batch_inv runs the
    ladder per-lane only for the total; scans dominate)."""
    return 4 * n + 380


def recover(g: int, n: int) -> int:
    """Fused pipeline (das/recovery._recover_fused_fn): zero-poly graph,
    5 (I)FFTs, 2 powers_of scans (~2n each), 5 pointwise mul passes,
    one batch inversion, and the in-graph self-check (eq only)."""
    return zero_poly(g, n) + 5 * fft_fr(n) + 2 * 2 * n + 5 * n + batch_inv(n)


# --- G1 pipeline counts (25-limb lazy Fp muls) ----------------------------

PROJ_ADD = 12
PROJ_DBL = 8
# fused GLV butterfly kernel (curve/pallas_g1.py _scalar_mul_glv_fn),
# per lane: domain entry for B (3) + jac_to_proj (3) + table build
# (7 proj_adds) + phi table (8) + 33 windows x (4 doubles + 2 digit
# adds) + entry/proj for A (6) + lo/hi adds (2 proj_adds) +
# 2 proj_to_jac (3 each) + 6 from_ext muls
GLV_BUTTERFLY = (
    3 + 3 + 7 * PROJ_ADD + 8
    + 33 * (4 * PROJ_DBL + 2 * PROJ_ADD)
    + 3 + 3 + 2 * PROJ_ADD + 2 * 3 + 6
)

# dynamic-scalar ladder kernel (_scalar_mul_fn), per lane: entry (3) +
# jac_to_proj (3) + table (7 adds) + 64 windows x (4 doubles + 1 digit
# add) + proj_to_jac (3) + exit (3)
DYN_LADDER = 3 + 3 + 7 * PROJ_ADD + 64 * (4 * PROJ_DBL + PROJ_ADD) + 3 + 3

# canonical-domain complete Jacobian add kernel (point_add_tile):
# 12 muls + the embedded double's 8 (both branches are computed)
JAC_ADD = 20


def fft_g1(n: int, inverse: bool = False) -> int:
    """log2(n) fused GLV butterfly stages of n/2 lanes (+ the 1/n
    post-scale pass for the inverse: one more butterfly over n lanes)."""
    s = n.bit_length() - 1
    total = s * (n // 2) * GLV_BUTTERFLY
    if inverse:
        total += n * GLV_BUTTERFLY
    return total


def msm(n: int) -> int:
    """lin_comb_g1: per-point multiples table (7 batched adds) +
    tree_reduce over (n, 64 windows) (~n*64 adds) + 63-step Horner on
    one lane (negligible width)."""
    return (7 * n + 64 * n) * JAC_ADD


def fk20_multi_da(n: int, l: int) -> dict:
    """DAUsingFK20Multi at extended width 2n, coset size l: per-component
    Fp/Fr mul counts (fk20/multi.py pipeline). k = n/l proofs cover the
    half domain; output 2k proofs."""
    k = n // l
    fr_muls = l * fft_fr(2 * k)                # batched Toeplitz FFTs
    g1_muls = (
        l * 2 * k * DYN_LADDER                 # part2 pointwise scalar-mul
        + (l - 1) * 2 * k * JAC_ADD            # tree-sum of l point batches
        + fft_g1(2 * k, inverse=True)          # part3 inverse G1 FFT
        + fft_g1(2 * k)                        # final forward G1 FFT
    )
    return {"fr": fr_muls, "fp": g1_muls, "proofs": 2 * k}
