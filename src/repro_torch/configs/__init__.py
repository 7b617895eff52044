"""repro_torch.configs — the published architecture configs."""

from .archs import FULL, get_config

__all__ = ["FULL", "get_config"]
