"""Config system (port of ``tvc/config``)."""

from tvc_torch.config.loader import (  # noqa: F401
    Config,
    ConfigLoader,
    apply_overrides,
    deep_merge,
    get_by_path,
    get_config,
)
