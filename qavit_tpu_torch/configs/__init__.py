from qavit_tpu_torch.configs.model import BankConfig, ModelConfig
from qavit_tpu_torch.configs.presets import PRESETS, Preset, get_preset

__all__ = ["BankConfig", "ModelConfig", "PRESETS", "Preset", "get_preset"]
