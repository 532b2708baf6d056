"""Arch registry: importing this package registers the 10 assigned configs
(one module per arch), as ``repro.configs`` does in the JAX package."""

from repro_torch.configs import (falcon_mamba_7b, gemma2_9b, granite_20b,
                                 moonshot_v1_16b_a3b, phi3_vision_4_2b,
                                 qwen2_0_5b, qwen2_moe_a27b, qwen3_1_7b,
                                 recurrentgemma_2b, whisper_small)
from repro_torch.configs.shapes import (SHAPES, ShapeCell, applicable,
                                        cells_for)
from repro_torch.models.config import ARCHS, get_config

__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeCell", "applicable",
           "cells_for",
           "falcon_mamba_7b", "gemma2_9b", "granite_20b",
           "moonshot_v1_16b_a3b", "phi3_vision_4_2b", "qwen2_0_5b",
           "qwen2_moe_a27b", "qwen3_1_7b", "recurrentgemma_2b",
           "whisper_small"]
