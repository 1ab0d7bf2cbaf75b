from .serve import ServeConfig, Server
from .train import TrainConfig, Trainer, build_step_fn

__all__ = ["ServeConfig", "Server", "TrainConfig", "Trainer", "build_step_fn"]
