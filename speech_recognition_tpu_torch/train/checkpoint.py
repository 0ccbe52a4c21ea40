"""``.pt`` checkpoints (counterpart of speech_recognition_tpu/train/checkpoint.py's
save_weights / restore_weights): the model's ``state_dict``, parameters and
batch-norm running statistics, as the JAX package saves its variables.
The file name is ``model_checkpoint_name`` + ``.pt``, so ``--pretrained-model-path``
and ``run.inference --model-path`` both load it."""

import io

import torch

from ..utils import makedirs, open_file, path_join


def checkpoint_path(output_path: str, model, epoch: int, val_loss: float, val_accuracy: float) -> str:
    name = model.model_checkpoint_name.format(epoch=epoch, val_loss=val_loss, val_accuracy=val_accuracy)
    return path_join(output_path, "models", name + ".pt")


def save_weights(path: str, model) -> None:
    makedirs(path.rsplit("/", 1)[0])
    buffer = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, buffer)
    with open_file(path, "wb") as f:
        f.write(buffer.getvalue())


def restore_weights(path: str, model):
    """Load a ``.pt`` state_dict written by ``save_weights`` (or ``torch.save``) into ``model``."""
    with open_file(path, "rb") as f:
        state = torch.load(f, map_location="cpu", weights_only=True)
    model.load_state_dict(state)
    return model
