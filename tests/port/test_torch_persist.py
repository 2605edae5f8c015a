"""Saving and loading the port's settings (kzg_tpu_torch.kzg.persist) and
reading the JAX package's own files (convert.load_*_from_reference).

The arrays kzg_tpu's save_* wrote for kzg_env's settings and its FK20
settings at n2 = 16 (l = 2, and single) are recorded in the `persist`
group. Written back to npz files, they carry into the port's settings,
which save and load in the port's format; the loaded FK20 settings give
kzg_tpu's recorded proofs exactly (fk20:2:da, fk20_single:single), and the
loaded CRS its words. The fixed-base tables are not stored: the loaded
settings rebuild them at first use."""

import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    FK20_COEFFS,
    FK20_N2,
    TEST_SECRET,
    ref_to_port,
    reference,
)

from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.kzg import persist
from kzg_tpu_torch.kzg.settings import KZGSettings
from kzg_tpu_torch.kzg.setup import generate_testing_setup
from kzg_tpu_torch.ntt.domain import FFTSettings

FILES = {"kzg": ("max_scale", "s1_x", "s1_y", "s1_z", "g2_affine"),
         "fk20_multi": ("n2", "chunk_len", "xf_x", "xf_y", "xf_z"),
         "fk20_single": ("n2", "xe_x", "xe_y", "xe_z")}


def reference_file(tmp_path, name: str) -> str:
    """The file kzg_tpu's save_* wrote, rebuilt from the record."""
    path = str(tmp_path / f"ref_{name}.npz")
    np.savez_compressed(path, **{k: reference(f"persist:{name}:{k}",
                                              TEST_SECRET, CRS_SIZE, name)
                                 for k in FILES[name]})
    return path


def same_points(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.fixture(scope="module")
def setup():
    return generate_testing_setup(TEST_SECRET, CRS_SIZE, CPU)


def test_kzg_settings_from_reference_file_and_back(tmp_path, setup):
    s1, _, _, s2 = setup
    ks = convert.load_kzg_settings_from_reference(
        reference_file(tmp_path, "kzg"), device=CPU)
    assert ks.fs.max_scale == 5
    assert same_points(ks.secret_g1, s1)
    assert ks.secret_g2_affine == s2
    path = str(tmp_path / "kzg.npz")
    persist.save_kzg_settings(path, ks)
    with np.load(path) as z:
        assert set(FILES["kzg"]) <= set(z.files)
        assert z["s1_x"].dtype == np.int32 and z["s1_x"].shape == (17, 12)
        np.testing.assert_array_equal(
            z["g2_affine"], reference("persist:kzg:g2_affine", TEST_SECRET,
                                      CRS_SIZE, "kzg"))
    back = persist.load_kzg_settings(path, device=CPU)
    assert same_points(back.secret_g1, s1)
    assert back.secret_g2_affine == s2
    assert back.fs.max_scale == 5 and back.fs.device.type == "cpu"


def test_kzg_settings_with_partial_g2(tmp_path, setup):
    """Settings that hold [s^i]_2 only where the checks read it, and a
    prover's settings with none, round-trip."""
    s1, _, _, s2 = setup
    partial = [q if i in (1, 4) else None for i, q in enumerate(s2)]
    for g2 in (partial, None):
        path = str(tmp_path / f"kzg_{g2 is None}.npz")
        persist.save_kzg_settings(path, KZGSettings(FFTSettings(5, CPU), s1,
                                                    g2))
        back = persist.load_kzg_settings(path, device=CPU)
        assert back.secret_g2_affine == g2
        assert same_points(back.secret_g1, s1)


@pytest.mark.parametrize("kind", ["fk20_multi", "fk20_single"])
def test_fk20_settings_carried_saved_and_loaded(tmp_path, setup, kind):
    s1 = setup[0]
    ks = KZGSettings(FFTSettings(5, CPU), s1)
    ref_path = reference_file(tmp_path, kind)
    if kind == "fk20_multi":
        carried = convert.load_fk20_multi_from_reference(ref_path, ks)
        assert (carried.n2, carried.chunk_len) == (FK20_N2, 2)
        table = carried.x_ext_fft_files
    else:
        carried = convert.load_fk20_single_from_reference(ref_path, ks)
        assert carried.n2 == FK20_N2
        table = carried.x_ext_fft
    path = str(tmp_path / f"{kind}.npz")
    getattr(persist, f"save_{kind}")(path, carried)
    loaded = getattr(persist, f"load_{kind}")(path, ks)
    got = loaded.x_ext_fft_files if kind == "fk20_multi" else \
        loaded.x_ext_fft
    assert same_points(got, table)
    from kzg_tpu.field import fr as jfr

    poly = fr.from_int(FK20_COEFFS, CPU)
    if kind == "fk20_multi":
        proofs = loaded.da_using_fk20_multi(poly)
        want = reference("fk20:2:da", jfr.from_int(FK20_COEFFS), 2)
    else:
        proofs = loaded.fk20_single(poly)
        want = reference("fk20_single:single", jfr.from_int(FK20_COEFFS))
    assert g1.to_affine_ints_host(proofs) == g1.to_affine_ints_host(
        ref_to_port(want))
