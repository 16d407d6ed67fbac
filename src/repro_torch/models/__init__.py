from .common import ModelConfig
from .model_zoo import Model, build_model, cross_entropy
from .sharding import (ShardingRules, get_rules, make_rules, set_rules,
                       use_rules)

__all__ = ["ModelConfig", "Model", "build_model", "cross_entropy",
           "ShardingRules", "make_rules", "get_rules", "set_rules",
           "use_rules"]
