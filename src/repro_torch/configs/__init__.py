"""Config registry of the port: importing this package registers the
architectures the port serves (hymba-1.5b only, for now; the others are in
ROADMAP.md)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    get_config,
    list_archs,
    reduce_config,
    register,
)

# side-effect registration
from repro_torch.configs import hymba_1_5b  # noqa: F401,E402
