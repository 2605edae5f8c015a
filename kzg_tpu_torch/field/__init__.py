from . import constants, limbs  # noqa: F401
from . import fr, fp  # noqa: F401
