"""Model configuration registry: the port's copy of
speech_recognition_tpu/configs/model_config.py.

The same YAML schema: the ``model_name`` key dispatches to ``LASConfig``,
``DeepSpeechConfig``, ``ConformerConfig`` or ``TransducerConfig``.  The JAX
module's ``create_model`` methods build Flax models; the port builds its
models in ``run/common.create_model``.
"""

from dataclasses import dataclass
from typing import List

import yaml

from .data_config import ConfigValidationError, _check_literal, _check_type

_RNN_TYPES = ("rnn", "lstm", "gru")


def get_model_config(model_config_path: str):
    """Load a model config yaml and return the matching config instance
    (``ds2``/``deepspeech2`` -> DeepSpeechConfig, ``las`` -> LASConfig,
    ``conformer`` -> ConformerConfig, ``transducer``/``rnnt``/``rnn-t`` ->
    TransducerConfig)."""
    from ..utils.io import open_file

    with open_file(model_config_path) as f:
        model_config_dict = yaml.safe_load(f)

    model_name = model_config_dict["model_name"].lower()
    if model_name in ("ds2", "deepspeech2"):
        return DeepSpeechConfig(**model_config_dict)
    if model_name == "las":
        return LASConfig(**model_config_dict)
    if model_name == "conformer":
        return ConformerConfig(**model_config_dict)
    if model_name in ("transducer", "rnnt", "rnn-t"):
        return TransducerConfig(**model_config_dict)
    raise ConfigValidationError(f"Model Name: {model_name} is invalid!")


@dataclass
class LASConfig:
    """Config for the LAS model."""

    # RNN Type: one of ['rnn', 'lstm', 'gru']
    rnn_type: str
    # Vocab Size
    vocab_size: int
    # Encoder Hidden Dimension
    encoder_hidden_dim: int
    # Decoder Hidden Dimension
    decoder_hidden_dim: int
    # Encoder Layers
    num_encoder_layers: int
    # Decoder Layers
    num_decoder_layers: int
    # Dropout Rate
    dropout: float
    # Teacher forcing rate
    teacher_forcing_rate: float
    # Pad Token ID
    pad_id: int

    model_name: str = "LAS"

    def __post_init__(self):
        _check_literal("rnn_type", self.rnn_type, _RNN_TYPES)
        _check_type(
            self,
            "vocab_size",
            "encoder_hidden_dim",
            "decoder_hidden_dim",
            "num_encoder_layers",
            "num_decoder_layers",
            "dropout",
            "teacher_forcing_rate",
            "pad_id",
        )


@dataclass
class DeepSpeechConfig:
    """Config for the DeepSpeech2 model."""

    # number of convolution layers
    num_conv_layers: int
    # number of channels for each layer
    channels: List[int]
    # filter size for each layer
    kernel_sizes: List[List[int]]
    # stride for each layer
    strides: List[List[int]]
    # type of rnn, one of ['rnn', 'lstm', 'gru']
    rnn_type: str
    # number of recurrent layers
    num_reccurent_layers: int
    # hidden dimension size of rnn
    hidden_dim: int
    # dropout rate
    dropout: float
    # recurrent dropout rate
    recurrent_dropout: float
    # size of vocabulary
    vocab_size: int
    # the index of the CTC blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # number of Switch-routed MoE experts per recurrent layer (0 = dense trunk)
    moe_experts: int = 0
    # expert FFN hidden width (0 = 4x the trunk width)
    moe_hidden_dim: int = 0
    # experts per token (top-k routing)
    moe_k: int = 1
    # per-expert buffer headroom over the even-load token share
    moe_capacity_factor: float = 1.25
    # weight of the load-balancing auxiliary loss
    moe_aux_weight: float = 0.01

    model_name: str = "DeepSpeech2"

    def __post_init__(self):
        _check_literal("rnn_type", self.rnn_type, _RNN_TYPES)
        _check_type(
            self,
            "num_conv_layers",
            "num_reccurent_layers",
            "hidden_dim",
            "dropout",
            "recurrent_dropout",
            "vocab_size",
            "blank_index",
            "pad_index",
            "moe_experts",
            "moe_hidden_dim",
            "moe_k",
            "moe_capacity_factor",
            "moe_aux_weight",
        )
        if self.moe_experts and self.moe_k not in (1, 2):
            raise ConfigValidationError("'moe_k' must be 1 or 2")
        if not (
            self.num_conv_layers == len(self.channels) == len(self.kernel_sizes) == len(self.strides)
        ):
            raise ConfigValidationError("Convolution parameter number is invalid!")


@dataclass
class ConformerConfig:
    """Config for the Conformer-CTC model.  Shares the DS2 CTC contract:
    ``blank_index``/``pad_index`` drive the loss and the CTC decoders."""

    # size of vocabulary
    vocab_size: int
    # encoder width (model dim of every block)
    encoder_dim: int
    # number of conformer blocks
    num_layers: int
    # attention heads (head dim = encoder_dim / heads must be even for RoPE)
    num_attention_heads: int
    # depthwise conv kernel width inside each block
    conv_kernel_size: int
    # feed-forward expansion factor
    ffn_expansion: int
    # dropout rate
    dropout: float
    # channels of the stride-2 conv subsampling stem (one entry per 2x layer)
    subsample_channels: List[int]
    # the index of the CTC blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # rematerialize block activations in the backward pass (torch.utils.checkpoint per block)
    remat: bool = False
    # the JAX package's stacked-parameter layout; the port builds the same
    # unrolled model and ``weights.params_from_jax`` splits the stacked tree
    scan_layers: bool = False

    model_name: str = "Conformer"

    def __post_init__(self):
        _check_type(
            self,
            "vocab_size",
            "encoder_dim",
            "num_layers",
            "num_attention_heads",
            "conv_kernel_size",
            "ffn_expansion",
            "dropout",
            "blank_index",
            "pad_index",
            "remat",
            "scan_layers",
        )
        if self.encoder_dim % self.num_attention_heads:
            raise ConfigValidationError("'encoder_dim' must divide by 'num_attention_heads'")
        if (self.encoder_dim // self.num_attention_heads) % 2:
            raise ConfigValidationError("attention head dim must be even (RoPE pairs)")
        if not self.subsample_channels:
            raise ConfigValidationError("'subsample_channels' must be non-empty")


@dataclass
class TransducerConfig:
    """Config for the RNN-Transducer model: a Conformer encoder, an LSTM
    prediction network and an additive joint, trained on the lattice loss.
    ``blank_index`` is the transducer blank; ``pad_index`` pads token batches
    (the two may coincide at 0)."""

    # size of vocabulary
    vocab_size: int
    # encoder width (model dim of every conformer block)
    encoder_dim: int
    # number of conformer blocks in the encoder
    num_encoder_layers: int
    # attention heads (head dim = encoder_dim / heads must be even for RoPE)
    num_attention_heads: int
    # depthwise conv kernel width inside each block
    conv_kernel_size: int
    # feed-forward expansion factor
    ffn_expansion: int
    # channels of the stride-2 conv subsampling stem
    subsample_channels: List[int]
    # prediction-net LSTM width (and embedding dim)
    pred_dim: int
    # prediction-net LSTM layers
    num_pred_layers: int
    # joint-network width (additive combine -> tanh -> vocab)
    joint_dim: int
    # dropout rate
    dropout: float
    # the index of the transducer blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # rematerialize encoder block activations in the backward pass (torch.utils.checkpoint per block)
    remat: bool = False
    # pruned (banded) lattice: evaluate the joint only on a band of this many
    # label slots per encoder frame (ops/transducer_pruned.py); 0 = the dense lattice
    pruned_range: int = 0

    model_name: str = "Transducer"

    def __post_init__(self):
        _check_type(
            self,
            "vocab_size",
            "encoder_dim",
            "num_encoder_layers",
            "num_attention_heads",
            "conv_kernel_size",
            "ffn_expansion",
            "pred_dim",
            "num_pred_layers",
            "joint_dim",
            "dropout",
            "blank_index",
            "pad_index",
            "remat",
            "pruned_range",
        )
        if self.pruned_range < 0:
            raise ConfigValidationError("'pruned_range' must be >= 0 (0 = dense)")
        if self.encoder_dim % self.num_attention_heads:
            raise ConfigValidationError("'encoder_dim' must divide by 'num_attention_heads'")
        if (self.encoder_dim // self.num_attention_heads) % 2:
            raise ConfigValidationError("attention head dim must be even (RoPE pairs)")
        if not self.subsample_channels:
            raise ConfigValidationError("'subsample_channels' must be non-empty")
