"""ctypes binding to the host pairing library (native/pairing.cpp), the
port's counterpart of kzg_tpu/curve/pairing_native.py.

`build.host_library` compiles native/pairing.cpp with g++ into build/ at
first use; a failed build raises. There is no switch to the Python tower:
tests call `pairing.pairings_verify_python` by name where they want it.
"""

from __future__ import annotations

from .. import build


def _g1_blob(affine):
    """(x, y) ints or None -> (96 bytes, inf flag)."""
    if affine is None:
        return b"\x00" * 96, 1
    x, y = affine
    return x.to_bytes(48, "big") + y.to_bytes(48, "big"), 0


def _g2_blob(affine):
    """((x0, x1), (y0, y1)) ints or None -> (192 bytes, inf flag)."""
    if affine is None:
        return b"\x00" * 192, 1
    (x0, x1), (y0, y1) = affine
    return (x0.to_bytes(48, "big") + x1.to_bytes(48, "big")
            + y0.to_bytes(48, "big") + y1.to_bytes(48, "big")), 0


def pairings_verify(a1, a2, b1, b2) -> bool:
    """e(a1, a2) * e(b1, b2) == 1 on the native library, points in affine
    int form (None = infinity)."""
    lib = build.host_library()
    return bool(lib.kzg_pairings_verify(*_g1_blob(a1), *_g2_blob(a2),
                                        *_g1_blob(b1), *_g2_blob(b2)))
