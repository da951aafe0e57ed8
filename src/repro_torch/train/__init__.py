"""Training substrate of the port: optimizers, schedules and the trainer."""
from . import optim
from .trainer import make_train_step

__all__ = ["optim", "make_train_step"]
