"""kzg_tpu_torch: the PyTorch/CUDA port of kzg_tpu for one NVIDIA H100.

Same module names as kzg_tpu; values are int32 tensors of 32-bit words in
Montgomery form (field/limbs.py). Kernels are hand-written CUDA for sm_90a
under csrc/, built at first use (build.py). Entry points run on "cuda"
unless the caller passes device="cpu", where every kernel wrapper runs
its plain PyTorch version. This package imports neither JAX nor kzg_tpu.

The JAX package's `field/backend.py` and `utils/jaxcache.py` have no
counterpart: a wrapper routes by its tensor's device (the plain version
on the CPU; on the card the kernel, or an error), and build.py keeps
each kernel library built once per source. Sharded execution over a
`torch.distributed` device mesh, one process a rank, lives in
`kzg_tpu_torch.parallel`.
"""

__version__ = "0.1.0"

from . import field  # noqa: F401,E402
from . import poly  # noqa: F401,E402
from . import ntt  # noqa: F401,E402
from . import curve  # noqa: F401,E402
from . import kzg  # noqa: F401,E402
from . import fk20  # noqa: F401,E402
from . import das  # noqa: F401,E402
from . import eth  # noqa: F401,E402
from . import utils  # noqa: F401,E402
