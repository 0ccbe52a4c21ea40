"""``.pt`` checkpoints (counterpart of speech_recognition_tpu/train/checkpoint.py's
save_weights / restore_weights / latest_checkpoint): the model's ``state_dict``,
parameters and batch-norm running statistics, as the JAX package saves its
variables.  The file name is ``model_checkpoint_name`` + ``.pt``, so
``--pretrained-model-path`` and ``run.inference --model-path`` both load it.

``latest_checkpoint`` finds the newest one under a ``models`` directory,
local or gs://, for ``run.train --auto-resume``: JAX ranks Orbax checkpoint
directories, the port ranks the ``.pt`` files it saves, by the same rule
(``_pick_latest``).
"""

import io
import os
import re
from typing import List, Optional

import torch

from ..utils import is_remote, makedirs, open_file, path_join

_EPOCH_RX = re.compile(r"model-(\d+)epoch")


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


def _pick_latest(entries: List[tuple]) -> Optional[str]:
    """The newest checkpoint among ``(path, timestamp)`` pairs.

    Templated names (``model-{N}epoch...``) order by epoch number, so
    model-10epoch beats model-9epoch whatever the clocks say.  A non-templated
    entry strictly newer than the newest templated one still wins (a
    converted release checkpoint dropped into a resume directory).  Entries
    with no usable timestamp carry 0.0 and win only when nothing is templated."""
    if not entries:
        return None
    templated = [
        (int(m.group(1)), p, ts)
        for p, ts in entries
        for m in [_EPOCH_RX.search(os.path.basename(p))]
        if m
    ]
    if not templated:
        return max(entries, key=lambda e: (e[1], e[0]))[0]
    best_epoch, best_path, best_ts = max(templated)
    newer = [(ts, p) for p, ts in entries if not _EPOCH_RX.search(os.path.basename(p)) and ts > best_ts]
    if newer:
        return max(newer)[1]
    return best_path


def _remote_latest(directory: str) -> Optional[str]:
    """The newest ``.pt`` object directly under a gs:// prefix, by epoch number,
    else by the objects' ``updated`` timestamps."""
    from ..utils import io as uio

    gcs = uio._gcs()
    directory = directory.rstrip("/")
    bucket, prefix = gcs._split(directory)
    strip = len(prefix) + 1 if prefix else 0
    entries = []
    for item in gcs.list_objects_meta(bucket, prefix + "/" if prefix else ""):
        rel = item["name"][strip:]
        if "/" not in rel and rel.endswith(".pt"):
            entries.append((f"{directory}/{rel}", gcs.parse_rfc3339(item.get("updated", ""))))
    return _pick_latest(entries)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest ``.pt`` checkpoint directly under ``directory`` (local or gs://), or None."""
    if is_remote(directory):
        return _remote_latest(directory)
    if not os.path.isdir(directory):
        return None
    entries = [
        (path, os.path.getmtime(path))
        for name in os.listdir(directory)
        for path in [os.path.join(directory, name)]
        if name.endswith(".pt") and os.path.isfile(path)
    ]
    return _pick_latest(entries)
