#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` (``run.train`` over ``torch.distributed`` on the card) without the other phases.

    python3 tools/chip_smoke_phase9.py

Builds the kernels (``phase_setup``), writes the smoke run's clips, trains
LAS-small as phase 4 does (``run_train_path``: the plain run whose per-step
losses phase 9a is held to), then runs phase 9 (``run_distributed``).  Prints
every check as the whole script does, the launches of the phase, each part's
seconds and the failed checks; exits 1 if any check failed.  Needs one CUDA GPU.
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the repository root, above)


def main():
    t0 = time.perf_counter()
    cs.phase_setup()
    tmp = tempfile.mkdtemp(prefix="phase9_")
    try:
        wav_dir, data_config, _ = cs.write_inputs(tmp, np.random.default_rng(0))
        train_wavs, paths = cs.write_train_inputs(tmp, np.random.default_rng(1))
        cs.run_train_path(tmp, train_wavs, paths, data_config)
        ds2_paths = cs.write_ds2_tsvs(tmp, np.random.default_rng(2))
        t = time.perf_counter()
        print(cs.run_distributed(tmp, paths, ds2_paths, data_config, wav_dir))
        print(f"phase 9: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("FAILURES", cs.failures)
    print(f"total {time.perf_counter() - t0:.1f} s")
    sys.exit(1 if cs.failures else 0)


if __name__ == "__main__":
    main()
