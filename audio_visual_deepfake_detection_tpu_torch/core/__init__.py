from .config import (  # noqa: F401
    ArchConfig,
    TestConfig,
    arch_config_from,
    load_config,
    test_config_from,
)
from .runtime import entry_device, set_numerics, use_kernel  # noqa: F401
