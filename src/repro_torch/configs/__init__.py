from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig, get)
