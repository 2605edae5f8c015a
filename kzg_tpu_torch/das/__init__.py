from .zero_poly import zero_poly_via_multiplication  # noqa: F401
from .legacy import (  # noqa: F401
    batch_inv,
    erasure_code_recover,
    zero_poly_direct,
)
from .recovery import (  # noqa: F401
    recover_poly_from_samples,
    shift_poly,
    unshift_poly,
)
