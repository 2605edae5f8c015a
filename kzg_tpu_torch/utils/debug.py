"""Debug dumpers (kzg_tpu/utils/debug.py; reference: debug.go:9-27,
DebugG1s bls/bls_kilic.go:160): the canonical values of a batch, printed
as the JAX package prints them."""

from __future__ import annotations

import numpy as np


def fr_str(x) -> str:
    """The canonical decimal string of one Fr element (reference: FrStr)."""
    from ..field import fr

    return str(int(fr.to_int(x).reshape(-1)[0]))


def debug_frs(msg: str, values) -> None:
    """Dump an Fr batch (reference: debugFrs, debug.go:9-16)."""
    from ..field import fr

    print(f"---{msg}---")
    for i, v in enumerate(np.atleast_1d(fr.to_int(values))):
        print(f"#{i:4d}: {v}")


def debug_g1s(msg: str, points) -> None:
    """Dump a G1 batch as compressed hex (reference: DebugG1s,
    bls/bls_kilic.go:160-166)."""
    from ..curve import g1, serialization

    print(f"---{msg}---")
    for i, a in enumerate(g1.to_affine_ints(points)):
        print(f"#{i:4d}: {serialization.compress_g1(a).hex()}")
