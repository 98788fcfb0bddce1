from .step import (TrainState, init_train_state, make_train_step,
                   train_state_from_jax)

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "train_state_from_jax"]
