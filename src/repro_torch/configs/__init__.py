from repro_torch.configs.base import ARCH_IDS, ModelConfig, get  # noqa: F401
