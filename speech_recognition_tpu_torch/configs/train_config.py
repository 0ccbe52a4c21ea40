"""Training configuration: the port's copy of
speech_recognition_tpu/configs/train_config.py.

The same YAML schema and derived properties (``audio_pad_length`` /
``token_pad_length`` / ``total_steps`` / ``offset_steps``); ``data_config``
and ``model_config`` are paths to the nested configs, loaded during
construction.  Two defaults differ: ``device`` is ``"GPU"`` (the port's
entry points run on the card unless asked for the CPU), and
``on_device_frontend=None`` means off (the port computes features on the
host unless asked for the on-device frontend, where JAX turns it on for TPU
runs without the time warp).
"""

from dataclasses import dataclass
from math import ceil
from typing import Optional

import yaml

from .data_config import ConfigValidationError, DataConfig, _check_literal, _check_type
from .model_config import get_model_config

_MISSING = object()


@dataclass
class TrainConfig:
    # nested config paths (YAML keys `data_config` / `model_config`)
    data_config: str = None
    model_config: str = None

    # sentencepiece model path
    sp_model_path: Optional[str] = None
    # a tsv/tfrecord dataset file or glob pattern
    train_dataset_paths: str = None
    # a tsv/tfrecord dataset file or glob pattern
    dev_dataset_paths: str = None
    # the number of training dataset examples
    train_dataset_size: int = None
    # output directory for logs and checkpoints
    output_path: str = "output"

    # pretrained model checkpoint
    pretrained_model_path: Optional[str] = None

    # training parameters
    epochs: int = None
    steps_per_epoch: Optional[int] = None
    learning_rate: float = None
    min_learning_rate: float = 1.0e-5
    warmup_rate: float = 0.00
    warmup_steps: Optional[int] = None
    batch_size: int = None
    dev_batch_size: int = None

    # shuffle buffer size
    shuffle_buffer_size: int = 10000
    # policy for sequences longer than the max: "filter" | "slice"
    max_over_policy: Optional[str] = None

    # use tfrecord dataset
    use_tfrecord: bool = False
    # tensorboard update frequency
    tensorboard_update_freq: int = 1
    # use mixed precision (bfloat16)
    mixed_precision: bool = False
    # random seed
    seed: Optional[int] = None
    # skip first N epochs and start at epoch N + 1
    skip_epochs: int = 0
    # device to use: "GPU" (the default) or "CPU"
    device: str = "GPU"
    # capture a torch.profiler trace of N training steps into <output>/profile
    profile_steps: Optional[int] = None
    # compute the audio features (and SpecAugment) on the device from padded
    # raw audio; None and False both mean the host pipeline computes them
    on_device_frontend: Optional[bool] = None
    # comma-separated audio-length bucket boundaries for bucketed batching
    # (e.g. "512,1024,2048"); cuts pad waste vs the single max-length shape
    bucket_boundaries: Optional[str] = None
    # resume from the newest checkpoint in <output>/models automatically
    auto_resume: bool = False
    # tensor-parallel degree, FSDP and the multi-process bootstrap: only the
    # single-device defaults are ported
    model_parallel: int = 1
    # accumulate gradients over N train steps before each optimizer update
    # (optax.MultiSteps semantics): effective batch = N * batch_size.  The LR
    # schedule advances per optimizer update
    grad_accum_steps: int = 1
    fsdp: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def __post_init__(self):
        required = [
            "data_config",
            "model_config",
            "train_dataset_paths",
            "dev_dataset_paths",
            "train_dataset_size",
            "epochs",
            "learning_rate",
            "batch_size",
            "dev_batch_size",
        ]
        for name in required:
            if getattr(self, name) is None:
                raise ConfigValidationError(f"should pass '{name}' parameter")
        if not isinstance(self.data_config, str) or not isinstance(self.model_config, str):
            raise ConfigValidationError("'data_config'/'model_config' must be config file paths")
        if self.max_over_policy is not None:
            _check_literal("max_over_policy", self.max_over_policy, ("filter", "slice"))
        _check_literal("device", self.device, ("CPU", "GPU", "TPU"))
        _check_type(
            self,
            "train_dataset_size",
            "epochs",
            "learning_rate",
            "min_learning_rate",
            "warmup_rate",
            "batch_size",
            "dev_batch_size",
            "shuffle_buffer_size",
            "tensorboard_update_freq",
            "skip_epochs",
            "model_parallel",
            "grad_accum_steps",
        )
        if self.model_parallel < 1:
            raise ConfigValidationError("'model_parallel' must be >= 1")
        if self.grad_accum_steps < 1:
            raise ConfigValidationError("'grad_accum_steps' must be >= 1")

        self.data_config_path = self.data_config
        self.model_config_path = self.model_config
        self.data_config = DataConfig.from_yaml(self.data_config_path)
        self.model_config = get_model_config(self.model_config_path)

    @classmethod
    def from_yaml(cls, file_path: str) -> "TrainConfig":
        from ..utils.io import open_file

        with open_file(file_path) as f:
            return cls(**yaml.safe_load(f))

    @property
    def audio_pad_length(self) -> Optional[int]:
        """Static audio pad length (the data config's max)."""
        return self.data_config.max_audio_length

    @property
    def token_pad_length(self) -> Optional[int]:
        return self.data_config.max_token_length

    @property
    def total_steps(self) -> int:
        return (self.steps_per_epoch or ceil(self.train_dataset_size / self.batch_size)) * self.epochs

    @property
    def offset_steps(self) -> int:
        return (
            self.steps_per_epoch or ceil(self.train_dataset_size / self.batch_size)
        ) * self.skip_epochs
