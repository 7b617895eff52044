"""repro_torch.runtime — training loop, serving loop, fault tolerance."""

from . import fault, serve, train_loop
from .fault import Preempted, PreemptionHandler, StragglerMonitor, retry
from .serve import Request, ServeConfig, Server
from .train_loop import TrainConfig, TrainState, build_train_step, init_state, model_loss, run

__all__ = [
    "Preempted",
    "PreemptionHandler",
    "Request",
    "ServeConfig",
    "Server",
    "StragglerMonitor",
    "TrainConfig",
    "TrainState",
    "build_train_step",
    "fault",
    "init_state",
    "model_loss",
    "retry",
    "run",
    "serve",
    "train_loop",
]
