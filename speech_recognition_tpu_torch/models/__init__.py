"""The port's models: LAS and DeepSpeech2."""

from .deepspeech2 import DeepSpeech2
from .las import LAS

__all__ = ["DeepSpeech2", "LAS"]
