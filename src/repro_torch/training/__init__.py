from .serve_step import (ContinuousBatcher, Request, greedy_generate,
                         make_serve_step)

__all__ = ["make_serve_step", "greedy_generate", "ContinuousBatcher",
           "Request"]
