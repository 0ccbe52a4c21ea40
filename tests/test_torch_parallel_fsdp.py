"""The port's ``--fsdp`` (FSDP2 over the ``data`` axis, parallel/shard.py apply_fsdp) on two
spawned gloo ranks, float32 on the CPU.

- Placement: ``parallel.fsdp_spec`` on every parameter of the DeepSpeech2, LAS,
  Conformer and transducer mini models, mapped back onto the JAX layout
  (``weights.jax_axis_order``), is JAX ``fsdp_spec`` of the same leaf, at data
  sizes 2 and 4 and at the default and a low size floor.
- Training: DeepSpeech2 (Adam), LAS (SGD, unequal token counts) and two
  accumulated micro-steps of DeepSpeech2 (FSDP's reduce-scatter only on the
  update's micro-step), with the size floor lowered to 256 elements so that
  most leaves shard: against the one-process step and against JAX's step with
  ``shard_params(fsdp=True)`` on a 2-device ``data`` mesh; loss rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-5.
- The checkpoint: every rank gathers the whole state_dict, rank 0 writes it,
  and it loads with ``strict=True`` into a one-process model.
- The FSDP units: each model declares its blocks (``fsdp_blocks``), one per
  layer, each called through its ``forward`` on the loss route (where FSDP2's
  all-gather hangs); a model that declares none is refused.
"""

import numpy as np
import pytest
import torch

from .const import TEST_CONFORMER_CONFIG, TEST_DS_CONFIG, TEST_LAS_CONFIG, TEST_TRANSDUCER_CONFIG
from .torch_parallel_ref import CHANNELS, FREQ, ctc_batches, jax_steps, jax_variables, seq_batches
from .torch_ranks import _rows, assert_runs_match, build_model, run_ranks, specs_worker, train_steps

V = 256
FLOOR = 256  # the FSDP size floor of the training cases: most mini leaves shard


@pytest.mark.parametrize("config", [TEST_DS_CONFIG, TEST_LAS_CONFIG, TEST_CONFORMER_CONFIG, TEST_TRANSDUCER_CONFIG])
@pytest.mark.parametrize("data_size, floor", [(2, 2**14), (2, 64), (4, 64)])
def test_fsdp_spec_matches_jax_on_every_leaf(config, data_size, floor):
    import jax

    from speech_recognition_tpu.parallel.mesh import fsdp_spec as jax_fsdp_spec
    from speech_recognition_tpu_torch.parallel import fsdp_spec
    from speech_recognition_tpu_torch.weights import jax_axis_order, params_to_jax

    _, variables = jax_variables(config)
    port = build_model(dict(family={TEST_DS_CONFIG: "ds2", TEST_LAS_CONFIG: "las", TEST_CONFORMER_CONFIG: "conformer",
                                    TEST_TRANSDUCER_CONFIG: "transducer"}[config],
                            config=config, variables=variables, freq=FREQ, channels=CHANNELS))
    sharded = 0
    for name, p in port.named_parameters():
        order = jax_axis_order(name, p)
        got = fsdp_spec(p, data_size, floor, order)
        leaf = params_to_jax({name: p.detach()})["params"]
        for key in name.split(".")[:-1]:
            leaf = leaf[key]
        (value,) = leaf.values()
        want = tuple(jax_fsdp_spec(jax.ShapeDtypeStruct(value.shape, value.dtype), data_size, floor))
        want = want + (None,) * (value.ndim - len(want))
        assert tuple(got[d] for d in order) == want, name
        sharded += "data" in got
    assert sharded > 0


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    import optax

    out = {}
    model, variables = jax_variables(TEST_DS_CONFIG, dropout=0.0, vocab_size=V)
    spec = dict(family="ds2", config=TEST_DS_CONFIG, overrides=dict(dropout=0.0, vocab_size=V), variables=variables,
                freq=FREQ, channels=CHANNELS, batches=ctc_batches(4, 2, vocab=V), fsdp=True, fsdp_min_size=FLOOR,
                save=str(tmp_path_factory.mktemp("ckpt") / "model.pt"))
    out["ds2"] = (spec, model, {})
    out["ds2_accum"] = (dict(spec, accum=2, batches=ctc_batches(5, 2, vocab=V), save=None), model, dict(accum=2))
    model, variables = jax_variables(TEST_LAS_CONFIG, dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V)
    out["las"] = (dict(family="las", config=TEST_LAS_CONFIG, variables=variables, freq=FREQ, channels=CHANNELS,
                       sgd=0.1, overrides=dict(dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V),
                       batches=seq_batches(6, 2, vocab=V, token_counts=[7, 7, 3, 4]), fsdp=True,
                       fsdp_min_size=FLOOR), model, dict(tx=optax.sgd(0.1), teacher=True))
    return out


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    names = list(cases)
    runs = run_ranks(specs_worker, 2, tmp_path_factory.mktemp("fsdp"), [dict(cases[n][0], dp=2) for n in names])
    return {n: [runs[0][i], runs[1][i]] for i, n in enumerate(names)}


@pytest.mark.parametrize("name", ["ds2", "ds2_accum", "las"])
def test_fsdp_two_ranks_match_one_process(cases, two_ranks, name):
    rank0, rank1 = two_ranks[name]
    assert rank0["metrics"] == rank1["metrics"]
    assert_runs_match(rank0, train_steps(dict(cases[name][0], save=None)))
    for key, value in rank0["state"].items():
        np.testing.assert_array_equal(rank1["state"][key], value, err_msg=key)


@pytest.mark.parametrize("name", ["ds2", "ds2_accum", "las"])
def test_fsdp_two_ranks_match_jax_fsdp(cases, two_ranks, name):
    spec, model, kwargs = cases[name]
    want = jax_steps(model, spec["variables"], spec["batches"], dp=2, fsdp=True, fsdp_min_size=FLOOR, **kwargs)
    assert_runs_match(two_ranks[name][0], want)


def test_gathered_checkpoint_loads_strict_into_one_process_model(cases, two_ranks):
    from speech_recognition_tpu_torch.train import restore_weights

    spec = cases["ds2"][0]
    model = build_model(spec)
    restore_weights(spec["save"], model)  # load_state_dict(strict=True)
    state = torch.load(spec["save"], weights_only=True)
    assert set(state) == set(model.state_dict())
    for key, value in two_ranks["ds2"][0]["state"].items():
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value, err_msg=key)


def dtensor_worker(rank, world):
    """What each kernel wrapper does with a DTensor operand (here a sharded W)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from speech_recognition_tpu_torch.kernels import plain_route
    from speech_recognition_tpu_torch.ops.ce_vocab import fused_ce_vocab
    from speech_recognition_tpu_torch.ops.ctc_emissions import fused_ctc_emissions

    W = distribute_tensor(torch.randn(8, 16), init_device_mesh("cpu", (world,)), [Shard(1)])
    hid, b = torch.randn(3, 2, 8), torch.zeros(16)
    raised = []
    for call in (lambda: fused_ce_vocab(hid, W, b, torch.ones(3, 2, dtype=torch.long)),
                 lambda: fused_ctc_emissions(hid, W, b, torch.ones(3, 4, dtype=torch.long)),
                 lambda: plain_route(hid, [[W, b]])):  # nested operands too, as the RNN cells' lists
        try:
            call()
            raised.append(None)
        except TypeError as e:
            raised.append(str(e))
    return raised


def test_kernel_wrappers_refuse_dtensors(tmp_path):
    """A wrapper handed a DTensor raises rather than computing on the shard or
    gathering it quietly (a CPU DTensor would otherwise take the plain route)."""
    (raised,) = run_ranks(dtensor_worker, 1, tmp_path)
    assert all(r is not None and "DTensor" in r for r in raised), raised


BLOCK_DEPTHS = {  # config: the fields whose layers the model declares as its FSDP blocks
    TEST_DS_CONFIG: ("num_reccurent_layers",),
    TEST_LAS_CONFIG: ("num_encoder_layers",),
    TEST_CONFORMER_CONFIG: ("num_layers",),
    TEST_TRANSDUCER_CONFIG: ("num_encoder_layers", "num_pred_layers"),
}


@pytest.mark.parametrize("config_path", list(BLOCK_DEPTHS))
def test_declared_fsdp_blocks_run_through_forward(config_path):
    """``apply_fsdp`` shards each block a model declares: distinct submodules, one
    per layer, and the loss route calls every one through its ``forward``."""
    from speech_recognition_tpu_torch.configs import get_model_config
    from speech_recognition_tpu_torch.run.common import _MODELS
    from speech_recognition_tpu_torch.train.state import LossRoute

    config = get_model_config(config_path)
    model = _MODELS[type(config)](config, FREQ, CHANNELS, generator=torch.Generator().manual_seed(0)).train(True)
    blocks = model.fsdp_blocks()
    owned = {id(m) for m in model.modules()}
    assert len(blocks) == sum(getattr(config, f) for f in BLOCK_DEPTHS[config_path]) > 0
    assert len({id(b) for b in blocks}) == len(blocks) and all(id(b) in owned for b in blocks)
    called = []
    for block in blocks:
        block.register_forward_pre_hook(lambda module, args: called.append(id(module)))
    token_conditioned = config_path in (TEST_LAS_CONFIG, TEST_TRANSDUCER_CONFIG)
    ((model_input, y_true),) = (seq_batches if token_conditioned else ctc_batches)(0, 1)
    model_input, y_true = _rows(model_input, 0, 4), _rows(y_true, 0, 4)
    if getattr(model, "logits_time_major_supported", False):
        y_true = y_true.t()
    route = LossRoute(model, model.get_loss_fn(), model.get_metrics())
    loss, _ = route(model_input, y_true, True, torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    assert torch.isfinite(loss)
    assert set(called) == {id(b) for b in blocks}


def test_apply_fsdp_refuses_a_model_without_declared_blocks():
    from speech_recognition_tpu_torch.parallel.shard import apply_fsdp

    model = torch.nn.Linear(4, 4)
    with pytest.raises(TypeError, match="fsdp_blocks"):
        apply_fsdp(model, model, mesh=None)
