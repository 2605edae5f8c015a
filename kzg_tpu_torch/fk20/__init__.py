from .single import FK20SingleSettings  # noqa: F401
from .multi import FK20MultiSettings  # noqa: F401
from .toeplitz import (  # noqa: F401
    toeplitz_part1,
    toeplitz_part2,
    toeplitz_part3,
)
