"""Filesystem helpers that are transparent to ``gs://`` object-store paths: the
port's copy of speech_recognition_tpu/utils/io.py.

Local paths use the stdlib; ``gs://`` paths go to the stdlib GCS client in
:mod:`.gcs` when it can authenticate (emulator, explicit token, metadata
server, application default credentials), and raise otherwise.  The JAX
module's ``tf.io.gfile`` fallback is not ported: it needs TensorFlow.
"""

import glob as _glob
import os
import shutil
from typing import List


def is_remote(path: str) -> bool:
    return isinstance(path, str) and path.startswith("gs://")


def _gcs():
    """The GCS client module, when it can authenticate."""
    from . import gcs

    if not gcs.available():
        raise NotImplementedError(
            "gs:// paths need GCS credentials (STORAGE_EMULATOR_HOST / GCS_OAUTH_TOKEN / metadata server / "
            "application default credentials)"
        )
    return gcs


def path_join(*paths: str) -> str:
    """Join paths; '/'-join for gs://."""
    if paths and is_remote(paths[0]):
        return "/".join(p.rstrip("/") for p in paths)
    return os.path.join(*paths)


def open_file(path: str, mode: str = "r"):
    if is_remote(path):
        return _gcs().GFile(path, mode)
    return open(path, mode)


def glob(pattern: str) -> List[str]:
    if is_remote(pattern):
        return _gcs().glob(pattern)
    return sorted(_glob.glob(pattern))


def makedirs(path: str) -> None:
    if is_remote(path):
        _gcs().makedirs(path)
    else:
        os.makedirs(path, exist_ok=True)


def copy(src: str, dst: str, overwrite: bool = True) -> None:
    if is_remote(src) or is_remote(dst):
        _gcs().copy(src, dst, overwrite=overwrite)
    else:
        shutil.copy(src, dst)


def exists(path: str) -> bool:
    if is_remote(path):
        return _gcs().exists(path)
    return os.path.exists(path)


def walk_files(directory: str) -> List[str]:
    """All file paths under ``directory``, recursively (full paths).

    For gs:// this is one objects.list over the prefix (zero-byte directory
    marker objects are skipped); locally it is os.walk.
    """
    directory = directory.rstrip("/")
    if is_remote(directory):
        gcs = _gcs()
        bucket, prefix = gcs._split(directory)
        # bucket root has an empty prefix; "/" would match nothing
        list_prefix = prefix + "/" if prefix else ""
        return sorted(
            f"gs://{bucket}/{name}" for name in gcs.list_objects(bucket, list_prefix) if not name.endswith("/")
        )
    out = []
    for root, _dirs, files in os.walk(directory):
        out += [os.path.join(root, f) for f in files]
    return sorted(out)


def copy_tree(src: str, dst: str) -> None:
    """Recursively copy the file tree at ``src`` to ``dst``; either side may be local or gs://."""
    src = src.rstrip("/")
    dst = dst.rstrip("/")
    if not is_remote(dst):
        os.makedirs(dst, exist_ok=True)
    for f in walk_files(src):
        rel = f[len(src) + 1 :]
        target = path_join(dst, rel)
        if not is_remote(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
        copy(f, target)
