"""Values between the JAX package's arrays and the port's tensors.

The JAX package stores uint32 (..., 2N) arrays of 16-bit limbs in
Montgomery form; the port stores int32 (..., N) 32-bit words with the same
R. Converting is a repack of the same integer, in both directions. Inputs
here are numpy arrays (np.asarray of the JAX arrays), so this module needs
neither JAX nor the JAX package. The `load_*_from_reference` functions
read the files that kzg_tpu.kzg.persist's save_* write.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve.weierstrass import JacobianPoint
from .fk20.multi import FK20MultiSettings
from .fk20.single import FK20SingleSettings
from .kzg.persist import g2_from_bytes
from .kzg.settings import KZGSettings
from .ntt.domain import FFTSettings


def words_from_ref(limbs16, device="cuda") -> torch.Tensor:
    """uint32 (..., 2N) 16-bit limbs -> int32 (..., N) words."""
    a = np.asarray(limbs16, dtype=np.uint32)
    lo, hi = a[..., 0::2], a[..., 1::2]
    w = (lo | (hi << 16)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(w)).to(device)


def words_to_ref(t: torch.Tensor) -> np.ndarray:
    """int32 (..., N) words -> uint32 (..., 2N) 16-bit limbs."""
    w = t.detach().cpu().numpy().view(np.uint32)
    out = np.stack((w & 0xFFFF, w >> 16), axis=-1)
    return out.reshape(w.shape[:-1] + (2 * w.shape[-1],)).astype(np.uint32)


def point_from_ref(x, y, z, device="cuda") -> JacobianPoint:
    """Three (..., 24) Fp limb arrays -> a port JacobianPoint."""
    return JacobianPoint(*(words_from_ref(c, device) for c in (x, y, z)))


def point_to_ref(p: JacobianPoint):
    return tuple(words_to_ref(c) for c in p)


def kzg_settings_from_reference(fs: FFTSettings, secret_g1) -> KZGSettings:
    """Port settings on a JAX KZGSettings' `secret_g1`, given as its
    (x, y, z) numpy arrays."""
    return KZGSettings(fs, point_from_ref(*secret_g1, device=fs.device))


def fk20_settings_from_reference(fs: FFTSettings, secret_g1, n2: int,
                                 chunk_len: int,
                                 x_ext_fft_files) -> FK20MultiSettings:
    """Port settings from a JAX FK20MultiSettings' `ks.secret_g1` and
    `x_ext_fft_files`, each given as its (x, y, z) numpy arrays."""
    return FK20MultiSettings.from_reference_arrays(
        kzg_settings_from_reference(fs, secret_g1), n2, chunk_len,
        point_from_ref(*x_ext_fft_files, device=fs.device))


def fk20_single_settings_from_reference(fs: FFTSettings, secret_g1, n2: int,
                                        x_ext_fft) -> FK20SingleSettings:
    """Port settings from a JAX FK20SingleSettings' `ks.secret_g1` and
    `x_ext_fft`, each given as its (x, y, z) numpy arrays."""
    return FK20SingleSettings.from_reference_arrays(
        kzg_settings_from_reference(fs, secret_g1), n2,
        point_from_ref(*x_ext_fft, device=fs.device))


# ---- files that kzg_tpu.kzg.persist's save_* wrote (16-bit limbs) ----
def _ref_point(z, prefix: str, device) -> JacobianPoint:
    return point_from_ref(*(z[f"{prefix}_{c}"] for c in "xyz"),
                          device=device)


def load_kzg_settings_from_reference(path: str, device="cuda") -> KZGSettings:
    """The port's KZGSettings from kzg_tpu's save_kzg_settings file."""
    with np.load(path) as z:
        fs = FFTSettings(int(z["max_scale"]), device)
        return KZGSettings(fs, _ref_point(z, "s1", fs.device),
                           g2_from_bytes(z["g2_affine"]))


def load_fk20_single_from_reference(path: str,
                                    ks: KZGSettings) -> FK20SingleSettings:
    """The port's FK20SingleSettings on ks from kzg_tpu's
    save_fk20_single file."""
    with np.load(path) as z:
        return FK20SingleSettings.from_reference_arrays(
            ks, int(z["n2"]), _ref_point(z, "xe", ks.fs.device))


def load_fk20_multi_from_reference(path: str,
                                   ks: KZGSettings) -> FK20MultiSettings:
    """The port's FK20MultiSettings on ks from kzg_tpu's save_fk20_multi
    file."""
    with np.load(path) as z:
        return FK20MultiSettings.from_reference_arrays(
            ks, int(z["n2"]), int(z["chunk_len"]),
            _ref_point(z, "xf", ks.fs.device))
