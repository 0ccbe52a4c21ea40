"""Runtime utilities: logging, seeding, edit distance and the path helpers of
:mod:`.io`.  The port's copy of speech_recognition_tpu/utils/__init__.py."""

import logging
import random
import sys
from typing import Iterable, Union

import numpy as np

from .io import copy, copy_tree, exists, glob, is_remote, makedirs, open_file, path_join, walk_files

__all__ = [
    "get_logger",
    "set_random_seed",
    "levenshtein_distance",
    "path_join",
    "open_file",
    "glob",
    "makedirs",
    "copy",
    "copy_tree",
    "exists",
    "is_remote",
    "walk_files",
]


def get_logger(name: str) -> logging.Logger:
    """Stdout logger with '[time] message' format (reference utils.py:104-113)."""
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(logging.DEBUG)
    if not logger.hasHandlers():
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
        logger.addHandler(handler)
    return logger


def set_random_seed(seed: int) -> None:
    """Seed python & numpy RNGs (torch generators are seeded by their owners)."""
    random.seed(seed)
    np.random.seed(seed)


def levenshtein_distance(
    truth: Union[Iterable, str], hypothesis: Union[Iterable, str], normalize: bool = True
) -> Union[int, float]:
    """Edit distance, optionally normalized by truth length (reference utils.py:80-101).

    Vectorized over the inner loop with numpy: O(m) python iterations of O(n)
    numpy work instead of the reference's O(mn) python double loop.
    """
    truth = truth if isinstance(truth, str) else list(truth)
    hypothesis = hypothesis if isinstance(hypothesis, str) else list(hypothesis)
    m, n = len(truth), len(hypothesis)
    if m == 0 or n == 0:
        distance = max(m, n)
        return distance / m if (normalize and m) else (0.0 if normalize else distance)

    # map symbols to int ids for vectorized comparison
    ids = {}
    truth_ids = np.array([ids.setdefault(s, len(ids)) for s in truth], dtype=np.int64)
    hyp_ids = np.array([ids.setdefault(s, len(ids)) for s in hypothesis], dtype=np.int64)

    idx = np.arange(n + 1, dtype=np.int64)
    prev = idx.copy()
    for i in range(1, m + 1):
        # candidates from substitution/insertion are fully vectorizable;
        # the deletion term's left-to-right dependency is a min-scan:
        # cur[j] = min_{k<=j} (cand[k] + (j - k)) with cand[0] = i
        cand = np.empty(n + 1, dtype=np.int64)
        cand[0] = i
        np.minimum(prev[:-1] + (hyp_ids != truth_ids[i - 1]), prev[1:] + 1, out=cand[1:])
        prev = np.minimum.accumulate(cand - idx) + idx
    distance = int(prev[-1])
    return distance / m if normalize else distance
