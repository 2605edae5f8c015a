from . import debug, host_ec, profiling  # noqa: F401
