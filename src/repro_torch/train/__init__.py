from .train_step import (TrainState, init_train_state, make_train_step,
                         trainable)

__all__ = ["TrainState", "init_train_state", "make_train_step", "trainable"]
