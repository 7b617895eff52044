"""repro_torch.data — token pipelines (synthetic + memmap), per-host sharding."""

from .pipeline import DataConfig, MemmapSource, SyntheticSource, TokenPipeline

__all__ = ["DataConfig", "MemmapSource", "SyntheticSource", "TokenPipeline"]
