from .settings import KZGSettings  # noqa: F401
from .setup import (  # noqa: F401
    bench_kzg_settings,
    generate_testing_setup,
    generate_testing_setup_ints,
    insecure_kzg_settings_device,
    secret_from_string,
)
from .persist import (  # noqa: F401
    load_fk20_multi,
    load_fk20_single,
    load_kzg_settings,
    save_fk20_multi,
    save_fk20_single,
    save_kzg_settings,
)
