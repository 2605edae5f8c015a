"""Sharded paths over a mesh axis on torch.distributed: one process a
rank, each holding its contiguous block of the point/element axis
(mesh.py)."""

from .mesh import gather_rows, make_mesh, shard_rows  # noqa: F401
from .fft_sharded import fft_sharded  # noqa: F401
from .fft_g1_sharded import (  # noqa: F401
    fft_g1_sharded,
    reverse_bit_order_g1_sharded,
)
from .fk20_sharded import da_using_fk20_multi_sharded  # noqa: F401
from .msm_sharded import lin_comb_g1_sharded  # noqa: F401
