from repro_torch.configs.base import ArchConfig, RunConfig  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    get_arch, list_archs, smoke_variant,
)
