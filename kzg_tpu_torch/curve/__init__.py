from . import fp2, g1, g2, msm, pairing, serialization  # noqa: F401
# fft_g1 stays the submodule (call kzg_tpu_torch.curve.fft_g1.fft_g1):
# re-exporting the function would hide the module behind its name
from .fft_g1 import reverse_bit_order_g1  # noqa: F401
from .msm import lin_comb_g1, sum_g1  # noqa: F401
from .weierstrass import CurveOps, JacobianPoint  # noqa: F401
