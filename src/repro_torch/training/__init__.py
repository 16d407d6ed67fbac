from .train_step import init_training, make_train_step
from .serve_step import (ContinuousBatcher, Request, greedy_generate,
                         make_serve_step)

__all__ = ["make_train_step", "init_training", "make_serve_step",
           "greedy_generate", "ContinuousBatcher", "Request"]
