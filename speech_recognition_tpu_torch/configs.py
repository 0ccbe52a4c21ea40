"""Config classes, re-exported from the JAX package.

``speech_recognition_tpu.configs`` is plain dataclasses + PyYAML and imports
no JAX, so the port shares it rather than copying it.  The one method that
does reach JAX, ``DataConfig.make_audio_feature_fn``, is replaced by
:func:`speech_recognition_tpu_torch.ops.features.make_feature_fn`.
"""

from speech_recognition_tpu.configs.data_config import ConfigValidationError, DataConfig, SpecAugmentConfig
from speech_recognition_tpu.configs.model_config import LASConfig, get_model_config
from speech_recognition_tpu.configs.train_config import TrainConfig

__all__ = ["ConfigValidationError", "DataConfig", "LASConfig", "SpecAugmentConfig", "TrainConfig", "get_model_config"]
