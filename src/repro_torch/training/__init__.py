"""Training of the port: the train step and the fault-tolerant runner."""

from .trainer import TrainConfig, Trainer, build_train_step

__all__ = ["TrainConfig", "Trainer", "build_train_step"]
