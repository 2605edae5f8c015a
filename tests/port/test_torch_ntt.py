"""The port's Fr FFT (K2 stages, fr_scale exit) and bit reversal against
the JAX package: live where its compile is short, else its recorded
outputs (port_helpers.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import CPU, FFT_SCALES, fft_input, reference
from test_ntt import GOLDEN_IFFT_0_15

from kzg_tpu.field import fr as jfr
from kzg_tpu.ntt import FFTSettings as RefFFTSettings
from kzg_tpu.ntt import fft as ref_fft
from kzg_tpu.ntt import reverse_bit_order as ref_reverse_bit_order
from kzg_tpu_torch import convert
from kzg_tpu_torch.field import fr
from kzg_tpu_torch.ntt.bitrev import brp_permute
from kzg_tpu_torch.ntt.domain import FFTSettings
from kzg_tpu_torch.ntt.fft_fr import fft


def test_roots_tables_match_reference():
    ref = RefFFTSettings(6)
    fs = FFTSettings(6, CPU)
    assert torch.equal(fs.expanded_roots_of_unity, convert.words_from_ref(
        np.asarray(ref.expanded_roots_of_unity), CPU))
    assert torch.equal(fs.reverse_roots_of_unity, convert.words_from_ref(
        np.asarray(ref.reverse_roots_of_unity), CPU))


@pytest.mark.parametrize("scale", FFT_SCALES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_matches_reference(scale, inverse):
    vals = fft_input(scale)
    ref = reference(f"fft:{scale}:{int(inverse)}", jfr.from_int(vals))
    got = fft(FFTSettings(scale, CPU), fr.from_int(vals, CPU), inverse)
    assert torch.equal(got, convert.words_from_ref(ref, CPU))


def test_ifft_golden_vector():
    got = fft(FFTSettings(4, CPU), fr.from_int(list(range(16)), CPU),
              inverse=True)
    assert [str(v) for v in fr.to_int(got)] == GOLDEN_IFFT_0_15


def test_fft_pads_to_pow2_and_subdomain():
    """Zero-padding of a non-power-of-two input, on a larger domain (the
    twiddle stride), and a batch axis."""
    vals = [3, 1, 4, 1, 5]
    ref = np.asarray(ref_fft(RefFFTSettings(5),
                             jnp.asarray(jfr.from_int(vals))))
    fs = FFTSettings(5, CPU)
    got = fft(fs, fr.from_int(vals, CPU))
    assert got.shape == (8, 8)
    assert torch.equal(got, convert.words_from_ref(ref, CPU))
    batch = fr.from_int([vals + [0] * 3, list(range(8))], CPU)
    out = fft(fs, batch)
    assert torch.equal(out[0], got)
    assert torch.equal(out[1], fft(fs, batch[1]))
    assert torch.equal(fft(fs, out, inverse=True), batch)


def test_fft_too_large_raises():
    with pytest.raises(ValueError):
        fft(FFTSettings(2, CPU), fr.zeros((8,), CPU))


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_reverse_bit_order_matches_reference(n):
    x = fr.from_int(list(range(n)), CPU)
    ref = np.asarray(ref_reverse_bit_order(
        jnp.asarray(jfr.from_int(list(range(n))))))
    assert torch.equal(brp_permute(x), convert.words_from_ref(ref, CPU))
    b = x.reshape(1, n, 8).expand(3, n, 8)
    assert torch.equal(brp_permute(b, axis=1)[2], brp_permute(x))
