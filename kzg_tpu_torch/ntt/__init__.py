from .bitrev import (  # noqa: F401
    bit_reversal_indices,
    reverse_bit_order,
    reverse_bits_limited,
)
from .das import das_extend_interleaved, das_fft_extension  # noqa: F401
from .domain import FFTSettings, next_pow_of_2  # noqa: F401
from .fft_fr import coset_scale, fft  # noqa: F401
