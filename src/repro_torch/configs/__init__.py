"""Model configurations (copies of ``repro.configs``): the schema, the
eleven architectures (ten copied, and ``moonlight-16b-a3b``, the port's
own), their registry and the assigned input shapes."""
from repro_torch.configs.base import (MambaConfig, MLAConfig, ModelConfig,
                                      MoEConfig)
from repro_torch.configs.registry import ARCHS, get, list_archs, reduced
from repro_torch.configs.shapes import (SHAPES, SHAPES_BY_NAME, ShapeConfig,
                                  cells_for, shape_applicable)

__all__ = ["MambaConfig", "MLAConfig", "ModelConfig", "MoEConfig", "ARCHS",
           "get", "list_archs", "reduced", "SHAPES", "SHAPES_BY_NAME",
           "ShapeConfig", "cells_for", "shape_applicable"]
