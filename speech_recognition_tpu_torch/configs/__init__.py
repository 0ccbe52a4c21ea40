"""Config classes: the port's copies of speech_recognition_tpu/configs/ (same YAML schema)."""

from .data_config import ConfigValidationError, DataConfig, SpecAugmentConfig
from .model_config import ConformerConfig, DeepSpeechConfig, LASConfig, TransducerConfig, get_model_config
from .train_config import TrainConfig

__all__ = [
    "ConfigValidationError",
    "ConformerConfig",
    "DataConfig",
    "DeepSpeechConfig",
    "LASConfig",
    "SpecAugmentConfig",
    "TrainConfig",
    "TransducerConfig",
    "get_model_config",
]
