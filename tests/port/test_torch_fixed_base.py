"""The fixed-base route of FK20's Toeplitz product: the window tables
(`g1_window_table` with 64 windows) against the host oracle, and
`g1_fixed_base_mul` / `toeplitz_part2` against `g1.mul` (K3) and the JAX
package's recorded `g1_mul`; the FK20 settings run part 2 through it and
their proofs still equal the recorded ones."""

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    FK20_COEFFS,
    FK20_N,
    FK20_N2,
    TEST_SECRET,
    mul_case,
    random_ints,
    reference,
    ref_to_port,
    subgroup_affine,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1, msm
from kzg_tpu_torch.curve import kernels as gk
from kzg_tpu_torch.curve.weierstrass import JacobianPoint
from kzg_tpu_torch.field import fp, fr
from kzg_tpu_torch.fk20 import toeplitz
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.ntt.fft_fr import fft
from kzg_tpu_torch.utils import host_ec

R = fr.SPEC.modulus
P = fp.SPEC.modulus


def proj_affine(words: torch.Tensor) -> list:
    """(n, 36) projective words -> affine ints (x/z, y/z), None at z = 0."""
    out = []
    for row in words.reshape(-1, 3, 12):
        x, y, z = (int(v) for v in fp.to_int(row))
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, P)
        out.append((x * zi % P, y * zi % P))
    return out


def test_window_table_matches_oracle():
    """Entry m of window w of base B is (m+1) 16^w B, for a few bases
    (one at infinity) and windows; with a gather index and one window,
    the [1..8] tables of a G1 FFT stage."""
    aff = subgroup_affine(120, 3)
    aff[1] = None
    pts = g1.from_affine_ints(aff, CPU)
    tables = gk.g1_window_table(pts, 64)
    assert tables.shape == (3, 64, 8, 36) and tables.dtype == torch.int32
    for w in (0, 1, 17, 63):
        for b in range(3):
            got = proj_affine(tables[b, w])
            assert got == [host_ec.g1_mul(aff[b], (m + 1) << (4 * w))
                           for m in range(8)]
    src = torch.tensor([2, 0, 1], dtype=torch.int32)
    gathered = gk.g1_window_table(pts, 1, src, 3)
    assert torch.equal(gathered[:, 0], tables[[2, 0, 1], 0])


def test_fixed_base_mul_matches_mul():
    """g1_fixed_base_mul on mul_case's lanes (infinity in both encodings,
    the scalars 0, 1 and r-1) equals g1.mul, the host oracle and the
    recorded JAX g1_mul."""
    aff, pts, ks = mul_case()
    scalars = fr.from_int(ks, CPU)
    digits = fr.scalar_windows_signed(scalars)
    got = gk.g1_fixed_base_mul(gk.g1_window_table(pts, 64), digits)
    want = g1.to_affine_ints(g1.mul(pts, scalars))
    assert g1.to_affine_ints(got) == want
    assert want == [host_ec.g1_mul(p, k) for p, k in zip(aff, ks)]
    rec = reference("g1_mul", *convert.point_to_ref(pts), jfr.from_int(ks))
    assert want == g1.to_affine_ints(ref_to_port(rec))


def test_toeplitz_part2_matches_mul():
    """Part 2 over a (2, 4) batch: the fixed-base product of the FFT of
    the coefficients equals g1.mul of the points by it; the wrapper takes
    its plain version on the CPU and launches nothing."""
    rng = np.random.default_rng(121)
    fs = FFTSettings(4, CPU)
    aff = subgroup_affine(122, 8)
    pts = JacobianPoint(*(c.reshape(2, 4, 12)
                          for c in g1.from_affine_ints(aff, CPU)))
    coeffs = fr.from_int(random_ints(rng, 8, R), CPU).reshape(2, 4, 8)
    gk.reset_launches()
    tables = msm.fixed_base_tables(pts)
    assert tables.shape == (2, 4, 64, 8, 36)
    got = toeplitz.toeplitz_part2(fs, coeffs, tables)
    assert got.x.shape == (2, 4, 12)
    assert set(gk.LAUNCHES.values()) == {0}
    want = g1.mul(pts, fft(fs, coeffs))
    flat = [JacobianPoint(*(c.reshape(8, 12) for c in p)) for p in (got, want)]
    assert g1.to_affine_ints(flat[0]) == g1.to_affine_ints(flat[1])
    with pytest.raises(ValueError):
        toeplitz.toeplitz_part2(fs, coeffs[:1], tables)
    meta = torch.empty_like(tables[0], device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gk.g1_fixed_base_mul(meta.reshape(-1, 64, 8, 36),
                             torch.zeros((4, 64), dtype=torch.int32,
                                         device="meta"))


def test_fk20_multi_runs_part2_on_fixed_base(monkeypatch):
    """The l = 4 settings from the recorded part-1 tables: part 2 goes
    through g1_fixed_base_mul, once, on the settings' tables, and the
    proofs equal the recorded fk20_multi_da_optimized."""
    l = 4
    crs = reference("crs", TEST_SECRET, CRS_SIZE)
    tables = reference(f"fk20:{l}:tables", TEST_SECRET, CRS_SIZE, l)
    fkm = convert.fk20_settings_from_reference(FFTSettings(5, CPU), crs,
                                               FK20_N2, l, tables)
    calls = []

    def counted(tbl, digits):
        calls.append(tbl.shape)
        return gk.g1_fixed_base_mul(tbl, digits)

    monkeypatch.setattr(toeplitz, "g1_fixed_base_mul", counted)
    ext = FK20_COEFFS + [0] * FK20_N
    got = fkm.fk20_multi_da_optimized(fr.from_int(ext, CPU))
    assert calls == [(l * FK20_N2 // l, 64, 8, 36)]
    assert fkm.x_ext_fft_tables.shape == (l, FK20_N2 // l, 64, 8, 36)
    want = reference(f"fk20:{l}:da_optimized", jfr.from_int(ext), l)
    assert g1.to_affine_ints(got) == g1.to_affine_ints(ref_to_port(want))
