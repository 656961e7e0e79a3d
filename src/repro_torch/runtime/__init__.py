"""Training runtime."""
from repro_torch.runtime.train_loop import Trainer, TrainStep, make_train_step

__all__ = ["TrainStep", "Trainer", "make_train_step"]
