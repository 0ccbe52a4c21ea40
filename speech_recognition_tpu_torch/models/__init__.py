"""The port's models: LAS, DeepSpeech2, the Conformer and the RNN-Transducer."""

from .conformer import Conformer
from .deepspeech2 import DeepSpeech2
from .las import LAS
from .transducer import Transducer

__all__ = ["Conformer", "DeepSpeech2", "LAS", "Transducer"]
