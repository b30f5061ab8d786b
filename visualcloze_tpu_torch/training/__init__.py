"""The trainer of the port: batches, the train step, checkpoints and the CLI."""

from .step import TrainState, init_train_state, make_optimizer, make_train_step, trainable_mask

__all__ = ["TrainState", "init_train_state", "make_optimizer", "make_train_step", "trainable_mask"]
