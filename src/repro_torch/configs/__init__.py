"""Model configurations (copies of ``repro.configs``): the schema, the
ten architectures, their registry and the assigned input shapes."""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import ARCHS, get, list_archs, reduced
from repro_torch.configs.shapes import (SHAPES, SHAPES_BY_NAME, ShapeConfig,
                                  cells_for, shape_applicable)

__all__ = ["MambaConfig", "ModelConfig", "MoEConfig", "ARCHS", "get",
           "list_archs", "reduced", "SHAPES", "SHAPES_BY_NAME",
           "ShapeConfig", "cells_for", "shape_applicable"]
