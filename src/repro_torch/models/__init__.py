"""repro_torch.models — model configurations and the model -> kernel bridge.

So far the port holds what whole-model profiling reads: ``ModelConfig``
(``model``) and the registry of profiled models with its kernel
derivation (``registry``).  The forward pass comes with its own slice.
"""

from . import model, registry
from .model import BlockKind, ModelConfig

__all__ = ["BlockKind", "ModelConfig", "model", "registry"]
