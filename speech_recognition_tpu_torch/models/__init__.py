"""The port's models: LAS, DeepSpeech2 and the Conformer."""

from .conformer import Conformer
from .deepspeech2 import DeepSpeech2
from .las import LAS

__all__ = ["Conformer", "DeepSpeech2", "LAS"]
