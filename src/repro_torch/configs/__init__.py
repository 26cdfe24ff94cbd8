from .base import (ARCHS, LayerSpec, ModelConfig, get_config,
                   get_reduced_config, list_archs)

__all__ = ["ARCHS", "LayerSpec", "ModelConfig", "get_config",
           "get_reduced_config", "list_archs"]
