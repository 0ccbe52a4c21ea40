"""The port's sequence parallelism (speech_recognition_tpu_torch/parallel/sequence.py,
``ops/frontend.py make_sp_batch_frontend``) against the JAX package's, on the CPU.

One spawned job of 4 gloo ranks (``tests/torch_ranks.py sequence_parallel_worker``)
runs every rank-side check; JAX's side runs here on the 8 virtual CPU devices.

- ``halo_exchange`` over 4 ranks with ``left=1, right=2``: each rank's extended
  block equal to JAX's ``shard_map`` of its ``halo_exchange``, exactly (zeros at
  the chain's ends); its backward, the reverse shift, equal to JAX's VJP for
  the same cotangents, exactly.
- ``make_sp_batch_frontend`` on a ``model`` group of 4 at the mini (log-mel) and
  Kspon (MFCC) configs, 41 frames (not divisible into 4 shards, so the padding
  runs): features within rtol / atol 1e-5 of the port's one-process
  ``make_batch_frontend`` on the same batch (JAX pins its SP frontend to its
  base frontend at this tolerance), frame lengths equal; and within 2e-3 of
  JAX's SP frontend, the tolerance tests/test_torch_frontend.py holds the two
  packages' base frontends to (float32 DFT products summed in another order,
  then a log).
- SpecAugment's masks (Kspon, no warp) on a 2 data x 2 model mesh, fed JAX's
  draws for the same key (``test_torch_spec_augment.py jax_draws``): 1e-5 of
  the port's base frontend with those draws, 2e-3 of JAX's SP frontend with
  that key over its ``('data', 'model')`` mesh.
- The mini config on the 2 x 2 mesh without SpecAugment (each data rank its
  rows): 1e-5 of the base frontend, 2e-3 of JAX's SP frontend with
  ``data_axis="data"``; and with a generator seeded alike on every rank (each
  data rank keeps its rows of the global draw): 1e-5 of the one-process base
  frontend on the whole batch with that seed.
- In one process: ``time_sharded`` without a ``model`` group is ``fn`` on the
  whole input with zero halos, and the frontend refuses ``frame_length %
  frame_step != 0`` with JAX's message.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from speech_recognition_tpu.configs import DataConfig as JaxDataConfig
from speech_recognition_tpu.ops.frontend import make_sp_batch_frontend as jax_sp_frontend
from speech_recognition_tpu.parallel.sequence import halo_exchange as jax_halo_exchange
from speech_recognition_tpu_torch.configs import DataConfig
from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend, make_sp_batch_frontend
from speech_recognition_tpu_torch.ops.spec_augment import SpecAugmentDraws
from speech_recognition_tpu_torch.parallel import time_sharded

from .const import KSPON_MINI_DATA_CONFIG, TEST_DATA_DIR
from .test_torch_spec_augment import cat_draws, jax_draws
from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)
from .torch_ranks import run_ranks, sequence_parallel_worker

MINI = os.path.join(TEST_DATA_DIR, "mini_data_config.yml")
WORLD, LEFT, RIGHT = 4, 1, 2
TIGHT = dict(rtol=1e-5, atol=1e-5)  # the SP frontend against the base frontend (JAX's own pin)
ACROSS = dict(rtol=2e-3, atol=2e-3)  # the port's frontend against JAX's (tests/test_torch_frontend.py)
SEED = 11


def _audio(cfg, frames, lengths, seed):
    S = (frames - 1) * cfg.frame_step + cfg.frame_length
    lengths = np.asarray([S if n is None else (S + n if n < 0 else n) for n in lengths], np.int32)
    audio = np.random.default_rng(seed).normal(0.0, 0.1, (len(lengths), S)).astype(np.float32)
    audio *= np.arange(S)[None, :] < lengths[:, None]
    return audio, lengths


def _no_warp(path):
    cfg, jcfg = DataConfig.from_yaml(path), JaxDataConfig.from_yaml(path)
    cfg.spec_augment.W = jcfg.spec_augment.W = None
    return cfg, jcfg


def _jax_mesh(dp, mp):
    devices = np.asarray(jax.devices()[:dp * mp])
    return JaxMesh(devices.reshape(dp, mp), ("data", "model")) if dp > 1 else JaxMesh(devices, ("model",))


def _cases():
    cfg, _ = _no_warp(MINI)
    kcfg, _ = _no_warp(KSPON_MINI_DATA_CONFIG)
    mini = _audio(cfg, 41, [None, -777, 1000], 0)
    kspon = _audio(kcfg, 41, [None, -777, 1000], 1)
    sa = _audio(kcfg, 33, [None, -500, None, 2400], 2)
    dm = _audio(cfg, 25, [None, -320, 900, None], 3)
    key = jax.random.PRNGKey(7)
    feats_t = (sa[0].shape[1] - kcfg.frame_length) // kcfg.frame_step + 1
    draws = cat_draws([jax_draws(k, feats_t, kcfg.frequency_dim, kcfg.spec_augment)
                       for k in jax.random.split(key, sa[0].shape[0])])
    draws = {k: None if getattr(draws, k) is None else getattr(draws, k).numpy()
             for k in SpecAugmentDraws.__dataclass_fields__}
    return {
        "mini": {"config": MINI, "dp": 1, "mp": WORLD, "audio": mini[0], "lengths": mini[1]},
        "kspon": {"config": KSPON_MINI_DATA_CONFIG, "dp": 1, "mp": WORLD, "audio": kspon[0], "lengths": kspon[1]},
        "spec_augment": {"config": KSPON_MINI_DATA_CONFIG, "dp": 2, "mp": 2, "audio": sa[0], "lengths": sa[1],
                         "draws": draws, "key": key},
        "data_axis": {"config": MINI, "dp": 2, "mp": 2, "audio": dm[0], "lengths": dm[1]},
        "data_axis_seeded": {"config": MINI, "dp": 2, "mp": 2, "audio": dm[0], "lengths": dm[1], "seed": SEED},
    }


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(the cases, JAX's halo blocks and VJP, each rank's results), one spawned job of 4 ranks."""
    cases = _cases()
    rng = np.random.default_rng(5)
    x = np.arange(WORLD * 3, dtype=np.float32).reshape(1, WORLD * 3)
    cot = rng.normal(size=(WORLD, 1, 3 + LEFT + RIGHT)).astype(np.float32)
    send = [{k: v for k, v in c.items() if k != "key"} for c in cases.values()]
    ranks = run_ranks(sequence_parallel_worker, WORLD, tmp_path_factory.mktemp("sp"), (x, LEFT, RIGHT, cot), send)
    return cases, _jax_halo(x, cot), ranks


def _jax_halo(x, cot):
    """JAX's extended blocks (one row per rank) and its halo exchange's VJP for the cotangents ``cot``."""
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
    fn = jax.shard_map(lambda b: jax_halo_exchange(b, "seq", time_axis=1, left=LEFT, right=RIGHT), mesh=mesh,
                       in_specs=(P(None, "seq"),), out_specs=P(None, "seq"), check_vma=False)
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    (grad,) = vjp(jnp.asarray(cot.transpose(1, 0, 2).reshape(1, -1)))
    return np.asarray(out).reshape(WORLD, -1), np.asarray(grad).reshape(WORLD, -1)


def test_halo_exchange_neighbor_edges(job):
    _, (want, _), ranks = job
    got = np.stack([r["halo"][0] for r in ranks])
    np.testing.assert_array_equal(got, want)
    # rank 1 owns [3, 4, 5]: its left halo is rank 0's last, its right rank 2's first two; the chain's ends are zeros
    np.testing.assert_array_equal(got[1], [2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(got[0], [0, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(got[3], [8, 9, 10, 11, 0, 0])


def test_halo_exchange_backward_is_the_reverse_shift(job):
    _, (_, want), ranks = job
    np.testing.assert_array_equal(np.stack([r["halo_grad"][0] for r in ranks]), want)


def _whole(ranks, index):
    """The ranks' features of a case, each data position's rows once, in row order; every rank of a
    model group holds the same (the group's gathered output)."""
    got = {}
    for r in ranks:
        res = r["frontends"][index]
        lo, _ = res["rows"]
        if lo in got:
            np.testing.assert_array_equal(res["feats"], got[lo][0])
        got[lo] = (res["feats"], res["valid"])
    feats = np.concatenate([got[lo][0] for lo in sorted(got)])
    valid = np.concatenate([got[lo][1] for lo in sorted(got)])
    return feats, valid


def _port_base(case, cfg, draws=None, seed=None):
    kwargs = {}
    if draws is not None:
        kwargs["draws"] = SpecAugmentDraws(**{k: None if v is None else torch.from_numpy(v) for k, v in draws.items()})
    if seed is not None:
        kwargs["generator"] = torch.Generator().manual_seed(seed)
    base = make_batch_frontend(cfg, spec_augment=bool(kwargs))
    feats, valid = base(torch.from_numpy(case["audio"]), torch.from_numpy(case["lengths"]), **kwargs)
    return feats.numpy(), valid.numpy()


def _jax_sp(case, jcfg, key=None):
    mesh = _jax_mesh(case["dp"], case["mp"])
    sp = jax_sp_frontend(jcfg, mesh, seq_axis="model", data_axis="data" if case["dp"] > 1 else None,
                         spec_augment=key is not None)
    args = (jnp.asarray(case["audio"]), jnp.asarray(case["lengths"])) + (() if key is None else (key,))
    feats, valid = sp(*args)
    return np.asarray(feats), np.asarray(valid)


@pytest.mark.parametrize("name", ["mini", "kspon"])
def test_sp_frontend_matches_base_and_jax(job, name):
    cases, _, ranks = job
    index = list(cases).index(name)
    case = cases[name]
    cfg, jcfg = _no_warp(case["config"])
    feats, valid = _whole(ranks, index)
    base, base_valid = _port_base(case, cfg)
    np.testing.assert_array_equal(valid, base_valid)
    assert feats.shape == base.shape
    np.testing.assert_allclose(feats, base, **TIGHT)
    want, want_valid = _jax_sp(case, jcfg)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(feats, want, **ACROSS)


def test_sp_frontend_with_spec_augment_masks(job):
    cases, _, ranks = job
    case = cases["spec_augment"]
    cfg, jcfg = _no_warp(case["config"])
    feats, _ = _whole(ranks, list(cases).index("spec_augment"))
    base, _ = _port_base(case, cfg, draws=case["draws"])
    np.testing.assert_allclose(feats, base, **TIGHT)
    assert not np.allclose(base, _port_base(case, cfg)[0])  # the masks zeroed something
    want, _ = _jax_sp(case, jcfg, key=case["key"])
    np.testing.assert_allclose(feats, want, **ACROSS)


def test_sp_frontend_composes_with_data_axis(job):
    cases, _, ranks = job
    case = cases["data_axis"]
    cfg, jcfg = _no_warp(case["config"])
    feats, valid = _whole(ranks, list(cases).index("data_axis"))
    base, base_valid = _port_base(case, cfg)
    np.testing.assert_array_equal(valid, base_valid)
    np.testing.assert_allclose(feats, base, **TIGHT)
    np.testing.assert_allclose(feats, _jax_sp(case, jcfg)[0], **ACROSS)


def test_sp_frontend_draws_the_global_batch_on_a_data_model_mesh(job):
    """Every rank's generator in the same state: each data rank applies its rows of the one-process draw."""
    cases, _, ranks = job
    case = cases["data_axis_seeded"]
    cfg = DataConfig.from_yaml(case["config"])
    cfg = dataclasses.replace(cfg, spec_augment=dataclasses.replace(cfg.spec_augment, enable=True, W=None))
    feats, _ = _whole(ranks, list(cases).index("data_axis_seeded"))
    base, _ = _port_base(case, cfg, seed=SEED)
    np.testing.assert_allclose(feats, base, **TIGHT)
    assert not np.allclose(base, _port_base(case, cfg)[0])  # the masks zeroed something


def test_time_sharded_without_a_group_is_fn_with_zero_halos():
    x = torch.arange(10.0).reshape(1, 10)
    got = time_sharded(lambda a: a * 2, None, time_axis=1, halo_left=1, halo_right=2)(x)
    want = torch.cat([torch.zeros(1, 1), x, torch.zeros(1, 2)], dim=1) * 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sp_frontend_refuses_partial_step_blocks():
    cfg = dataclasses.replace(DataConfig.from_yaml(MINI), frame_length=400)
    with pytest.raises(ValueError, match="frame_length % frame_step == 0"):
        make_sp_batch_frontend(cfg)
    jcfg = dataclasses.replace(JaxDataConfig.from_yaml(MINI), frame_length=400)
    with pytest.raises(ValueError, match="frame_length % frame_step == 0"):
        jax_sp_frontend(jcfg, _jax_mesh(1, 2))
