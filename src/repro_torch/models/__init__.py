from .common import ModelConfig
from .model_zoo import Model, build_model, cross_entropy

__all__ = ["ModelConfig", "Model", "build_model", "cross_entropy"]
