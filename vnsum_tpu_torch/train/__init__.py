from .checkpoint import TrainCheckpointer
from .trainer import TrainConfig, Trainer, lm_loss

__all__ = ["TrainCheckpointer", "TrainConfig", "Trainer", "lm_loss"]
