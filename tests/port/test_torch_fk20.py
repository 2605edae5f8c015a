"""The whole slice: FK20 multi proofs of the port against the JAX package
on the kzg_env shape (width-32 domain, 17-point CRS, n = 8, n2 = 16). The
port starts from the JAX package's own CRS and part-1 tables, carried over
with kzg_tpu_torch.convert; the JAX outputs are the recorded ones
(port_helpers.py). Proofs are also checked against coset proofs computed
by definition."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import (
    CPU,
    CRS_SIZE,
    FK20_CHUNKS,
    FK20_COEFFS,
    FK20_N,
    FK20_N2,
    TEST_SECRET,
    coset_proofs_oracle,
    ref_to_port,
    reference,
)

from kzg_tpu.field import fr as jfr
from kzg_tpu.fk20.multi import (
    toeplitz_coeffs_step_strided as ref_toeplitz_coeffs_step_strided,
)
from kzg_tpu_torch import convert
from kzg_tpu_torch.curve import g1
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.fk20.multi import (
    FK20MultiSettings,
    crs_indices,
    toeplitz_coeffs_step_strided,
)
from kzg_tpu_torch.kzg.settings import KZGSettings
from kzg_tpu_torch.kzg.setup import (
    generate_testing_setup,
    insecure_kzg_settings_device,
)
from kzg_tpu_torch.ntt.domain import FFTSettings

COEFFS, N, N2, SECRET = FK20_COEFFS, FK20_N, FK20_N2, TEST_SECRET


def affine(key: str, *inputs) -> list:
    return g1.to_affine_ints(ref_to_port(reference(key, *inputs)))


@pytest.mark.parametrize("l", FK20_CHUNKS)
def test_fk20_multi_da_matches_reference(l):
    crs = reference("crs", SECRET, CRS_SIZE)
    tables = reference(f"fk20:{l}:tables", SECRET, CRS_SIZE, l)
    port = convert.fk20_settings_from_reference(
        FFTSettings(5, CPU), crs, N2, l, tables)
    own = FK20MultiSettings(port.ks, N2, l)   # part 1 on the port
    assert g1.to_affine_ints(own.x_ext_fft_files) == \
        g1.to_affine_ints(port.x_ext_fft_files)

    poly = fr.from_int(COEFFS, CPU)
    got = g1.to_affine_ints(port.da_using_fk20_multi(poly))
    assert len(got) == N2 // l
    assert got == affine(f"fk20:{l}:da", jfr.from_int(COEFFS), l)
    assert got == coset_proofs_oracle(COEFFS, N2, l, SECRET, rbo=True)

    ext = COEFFS + [0] * N
    got_ext = port.fk20_multi_da_optimized(fr.from_int(ext, CPU))
    assert g1.to_affine_ints(got_ext) == \
        affine(f"fk20:{l}:da_optimized", jfr.from_int(ext), l)


@pytest.mark.parametrize("l", [1, 2, 4])
def test_fk20_multi_matches_oracle(l):
    fs = FFTSettings(5, CPU)
    s1, _, _, _ = generate_testing_setup(SECRET, 17, CPU)
    fkm = FK20MultiSettings(KZGSettings(fs, s1), N2, l)
    got = g1.to_affine_ints(fkm.fk20_multi(fr.from_int(COEFFS, CPU)))
    assert got == coset_proofs_oracle(COEFFS, N, l, SECRET, rbo=False)


def test_setups_match_reference(kzg_env):
    """The host testing setup and the device CRS (one K3 batch) equal the
    JAX package's CRS, live (the kzg_env fixture) and recorded."""
    _, ks_ref = kzg_env
    want = g1.to_affine_ints(ref_to_port(ks_ref.secret_g1))
    assert affine("crs", SECRET, CRS_SIZE) == want
    fs = FFTSettings(5, CPU)
    s1, _, aff, _ = generate_testing_setup(SECRET, 17, CPU)
    assert aff == want
    assert g1.to_affine_ints(s1) == want
    ks = insecure_kzg_settings_device(SECRET, 17, fs)
    assert g1.to_affine_ints(ks.secret_g1) == want


@pytest.mark.parametrize("l", [2, 4])
def test_toeplitz_coeffs_and_crs_indices_match_reference(l):
    vals = list(range(1, N + 1))
    for i in range(l):
        got = toeplitz_coeffs_step_strided(fr.from_int(vals, CPU), i, l)
        want = ref_toeplitz_coeffs_step_strided(
            jnp.asarray(jfr.from_int(vals)), i, l)
        assert torch.equal(got, convert.words_from_ref(np.asarray(want), CPU))
    idx = crs_indices(N, l)
    assert idx.shape == (l, N // l - 1)
    for i in range(l):   # kzg_tpu/fk20/multi.py:75-81
        assert idx[i].tolist() == list(range(N - 2 * l + i, i - 1, -l))


def test_settings_check_their_arguments():
    fs = FFTSettings(5, CPU)
    s1, _, _, _ = generate_testing_setup(SECRET, 17, CPU)
    ks = KZGSettings(fs, s1)
    for n2, l in ((12, 2), (64, 2), (16, 3), (16, 8)):
        with pytest.raises(ValueError):
            FK20MultiSettings(ks, n2, l)
    fkm = FK20MultiSettings(ks, N2, 2)
    with pytest.raises(ValueError):
        fkm.da_using_fk20_multi(fr.from_int(COEFFS + [0], CPU))
    with pytest.raises(ValueError):
        FK20MultiSettings.from_reference_arrays(ks, N2, 4, fkm.x_ext_fft_files)
