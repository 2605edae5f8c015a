"""Save and load precomputed settings (kzg_tpu/kzg/persist.py): the CRS
and the FK20 part-1 tables (the chunkLen G1 FFTs of NewFK20MultiSettings,
kzg.go:103-114) round-trip through npz, so a serving process skips
rebuilding them.

The files keep the JAX package's keys (max_scale, s1_*, g2_affine; n2,
xe_*; n2, chunk_len, xf_*), with the port's words: int32 (..., 12) in
Montgomery form. A KZG file adds `g2_known`, one flag an index, because
the port's settings may hold [s^i]_2 only where the checks read it
(kzg/setup.py); where it is 0 the row of g2_affine is zeros. The
fixed-base tables are not stored: the settings' cached properties
rebuild them at first use. `convert.py` reads the JAX package's own
files (16-bit limbs) into the port's settings.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curve.weierstrass import JacobianPoint
from ..ntt.domain import FFTSettings
from .settings import KZGSettings


def _pt_arrays(prefix: str, p: JacobianPoint) -> dict:
    return {f"{prefix}_{c}": t.cpu().numpy() for c, t in zip("xyz", p)}


def _pt_from(z, prefix: str, device) -> JacobianPoint:
    return JacobianPoint(*(torch.from_numpy(np.ascontiguousarray(
        z[f"{prefix}_{c}"])).to(device) for c in "xyz"))


def g2_to_bytes(g2_affine) -> tuple:
    """[s^i]_2 list (None where unknown) -> (uint8 (n, 4, 48) big-endian
    x0, x1, y0, y1; uint8 (n,) known flags)."""
    g2_affine = g2_affine or []
    out = np.zeros((len(g2_affine), 4, 48), dtype=np.uint8)
    known = np.zeros(len(g2_affine), dtype=np.uint8)
    for i, q in enumerate(g2_affine):
        if q is None:
            continue
        known[i] = 1
        (x0, x1), (y0, y1) = q
        for j, v in enumerate((x0, x1, y0, y1)):
            out[i, j] = np.frombuffer(v.to_bytes(48, "big"), np.uint8)
    return out, known


def g2_from_bytes(rows, known=None) -> list:
    """The inverse of g2_to_bytes; without flags every row is known."""
    out = []
    for i, r in enumerate(rows):
        if known is not None and not known[i]:
            out.append(None)
            continue
        x0, x1, y0, y1 = (int.from_bytes(bytes(v), "big") for v in r)
        out.append(((x0, x1), (y0, y1)))
    return out


def save_kzg_settings(path: str, ks: KZGSettings) -> None:
    g2b, known = g2_to_bytes(ks.secret_g2_affine)
    np.savez_compressed(path, max_scale=ks.fs.max_scale,
                        **_pt_arrays("s1", ks.secret_g1), g2_affine=g2b,
                        g2_known=known)


def load_kzg_settings(path: str, device="cuda") -> KZGSettings:
    with np.load(path) as z:
        fs = FFTSettings(int(z["max_scale"]), device)
        s1 = _pt_from(z, "s1", fs.device)
        known = z["g2_known"] if "g2_known" in z.files else None
        g2 = g2_from_bytes(z["g2_affine"], known)
    return KZGSettings(fs, s1, g2 or None)


def save_fk20_single(path: str, fk) -> None:
    np.savez_compressed(path, n2=fk.n2, **_pt_arrays("xe", fk.x_ext_fft))


def load_fk20_single(path: str, ks: KZGSettings):
    """FK20 single settings on ks, their table on ks's device."""
    from ..fk20.single import FK20SingleSettings

    with np.load(path) as z:
        return FK20SingleSettings(ks, int(z["n2"]),
                                  _pt_from(z, "xe", ks.fs.device))


def save_fk20_multi(path: str, fkm) -> None:
    np.savez_compressed(path, n2=fkm.n2, chunk_len=fkm.chunk_len,
                        **_pt_arrays("xf", fkm.x_ext_fft_files))


def load_fk20_multi(path: str, ks: KZGSettings):
    """FK20 multi settings on ks, their tables on ks's device."""
    from ..fk20.multi import FK20MultiSettings

    with np.load(path) as z:
        return FK20MultiSettings(ks, int(z["n2"]), int(z["chunk_len"]),
                                 _pt_from(z, "xf", ks.fs.device))
