"""speech_recognition_tpu_torch — the PyTorch/CUDA port of speech_recognition_tpu.

The JAX package beside it stays the reference: every module here names its
counterpart, and the CPU tests feed both the same numpy inputs.  Layout
mirrors the JAX package (``ops/``, ``models/``, ``search.py``, ``run/``).
Hand-written CUDA kernels live under ``csrc/``; ``kernels/`` builds them
with ``nvcc`` at first use and binds their C interface with ``ctypes``.

This package imports ``torch`` and never ``jax``, nor anything of the JAX
package: its host modules (``configs/``, ``data/``, ``utils/``) are its own
copies of the JAX package's, each naming the module it mirrors.
"""

__version__ = "0.1.0"
