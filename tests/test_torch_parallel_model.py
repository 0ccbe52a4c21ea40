"""The port's ``--model-parallel`` on spawned gloo ranks: tensor parallelism (the
vocab-dimension parameters stored as shards over ``model``, parallel/shard.py)
and expert parallelism (parallel/expert.py), float32 on the CPU.

- Placement: ``parallel.param_spec`` on every parameter of the LAS,
  DeepSpeech2, Conformer and transducer mini models, mapped onto the JAX
  layout, is JAX ``param_spec`` of the same leaf.
- Training, world 2 as ``model`` 2 and world 4 as 2 x 2: LAS, DeepSpeech2 and
  the transducer with SGD, as JAX's own LAS mesh test (Adam's sign-like update
  turns reduction-order noise in near-zero gradients into +-lr), at 0.1, and
  DeepSpeech2 at 0.01 (its GRU gradients differ between the packages by
  float32 noise of ~1e-4 relative, which a 0.1 step carries past atol 1e-5) against the one-process step and against JAX's
  step with ``shard_params(tensor_parallel=True)`` on a mesh of the same shape
  (tests/test_parallel.py:68-140, 201); DeepSpeech2-MoE, whose experts shard
  over ``model``, against JAX's step on the same mesh (JAX takes the
  expert-parallel path there too), and, with its capacity free and its aux
  weight 0 (the aux is a per-shard mean by design), against the one-process
  step.  Loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5.
- ``expert_parallel_moe`` against JAX's on the same ``(data, model)`` mesh
  (tests/test_expert_parallel.py): capacity free with k = 1 and 2, capacity
  binding (routing per source shard), outputs, aux, and the gradients of
  ``sum(y^2)`` and of the aux with respect to every parameter and the input:
  rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from .const import TEST_CONFORMER_CONFIG, TEST_DS_CONFIG, TEST_DS_MOE_CONFIG, TEST_LAS_CONFIG, TEST_TRANSDUCER_CONFIG
from .torch_parallel_ref import CHANNELS, FREQ, ctc_batches, jax_steps, jax_variables, seq_batches
from .torch_ranks import assert_runs_match, build_model, run_ranks, specs_worker, train_steps

V = 256
SGD = 0.1
SGD_GRU = 0.01  # DeepSpeech2's GRU gradients differ between the packages by float32 noise (~1e-4 relative)
D, H, E = 8, 16, 4
EP_CASES = {  # name: (k, capacity, data, model)
    "free_k1": (1, 16, 1, 2),
    "free_k2": (2, 16, 1, 2),
    "binding": (1, 2, 1, 2),
    "free_k1_2x2": (1, 16, 2, 2),
    "binding_2x2": (1, 2, 2, 2),
}


@pytest.mark.parametrize("config", [TEST_DS_CONFIG, TEST_LAS_CONFIG, TEST_CONFORMER_CONFIG, TEST_TRANSDUCER_CONFIG])
def test_param_spec_matches_jax_on_every_leaf(config):
    import jax

    from speech_recognition_tpu.parallel.mesh import param_spec as jax_param_spec
    from speech_recognition_tpu_torch.parallel import param_spec
    from speech_recognition_tpu_torch.weights import jax_axis_order, params_to_jax

    _, variables = jax_variables(config)
    port = build_model(dict(family={TEST_DS_CONFIG: "ds2", TEST_LAS_CONFIG: "las", TEST_CONFORMER_CONFIG: "conformer",
                                    TEST_TRANSDUCER_CONFIG: "transducer"}[config],
                            config=config, variables=variables, freq=FREQ, channels=CHANNELS))
    sharded = 0
    for name, p in port.named_parameters():
        tree = params_to_jax({name: p.detach()})["params"]
        path = []
        while isinstance(tree, dict):
            (key, tree), = tree.items()
            path.append(key)
        want = tuple(jax_param_spec("/".join(path), jax.ShapeDtypeStruct(tree.shape, tree.dtype)))
        got = param_spec(name, p)
        assert tuple(got[d] for d in jax_axis_order(name, p)) == want, name
        sharded += "model" in got
    assert sharded >= 1


def _cases():
    import optax

    out = {}
    model, variables = jax_variables(TEST_LAS_CONFIG, dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V)
    out["las"] = (dict(family="las", config=TEST_LAS_CONFIG, variables=variables, freq=FREQ, channels=CHANNELS,
                       sgd=SGD, overrides=dict(dropout=0.0, teacher_forcing_rate=1.0, vocab_size=V),
                       batches=seq_batches(7, 2, vocab=V, token_counts=[7, 5, 3, 6])),
                  model, dict(tx=optax.sgd(SGD), teacher=True))
    model, variables = jax_variables(TEST_DS_CONFIG, dropout=0.0, vocab_size=V)
    out["ds2"] = (dict(family="ds2", config=TEST_DS_CONFIG, overrides=dict(dropout=0.0, vocab_size=V), sgd=SGD_GRU,
                       variables=variables, freq=FREQ, channels=CHANNELS, batches=ctc_batches(8, 2, vocab=V)),
                  model, dict(tx=optax.sgd(SGD_GRU)))
    over = dict(dropout=0.0, vocab_size=V, num_encoder_layers=1)
    model, variables = jax_variables(TEST_TRANSDUCER_CONFIG, **over)
    out["transducer"] = (dict(family="transducer", config=TEST_TRANSDUCER_CONFIG, overrides=over, sgd=SGD,
                              variables=variables, freq=FREQ, channels=CHANNELS,
                              batches=seq_batches(9, 2, vocab=V, length=8, token_counts=[8, 6, 4, 5])),
                         model, dict(tx=optax.sgd(SGD)))
    model, variables = jax_variables(TEST_DS_MOE_CONFIG, dropout=0.0, vocab_size=V)
    out["moe"] = (dict(family="ds2", config=TEST_DS_MOE_CONFIG, overrides=dict(dropout=0.0, vocab_size=V),
                       sgd=SGD_GRU, variables=variables, freq=FREQ, channels=CHANNELS,
                       batches=ctc_batches(10, 2, vocab=V)), model, dict(tx=optax.sgd(SGD_GRU)))
    free = dict(dropout=0.0, vocab_size=V, moe_capacity_factor=8.0, moe_aux_weight=0.0)
    out["moe_free"] = (dict(out["moe"][0], overrides=free), None, {})
    return out


def ep_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(0, D ** -0.5, (D, E)).astype(np.float32),
            "w_in": rng.normal(0, D ** -0.5, (E, D, H)).astype(np.float32),
            "b_in": rng.normal(0, 0.1, (E, H)).astype(np.float32),
            "w_out": rng.normal(0, H ** -0.5, (E, H, D)).astype(np.float32),
            "b_out": rng.normal(0, 0.1, (E, D)).astype(np.float32)}


def ep_worker(rank, world, cases):
    """Each case: this rank's y rows, aux share and gradients (router and input
    summed over ``data``, expert weights this rank's shard)."""
    import torch.distributed as dist

    from speech_recognition_tpu_torch.parallel import get_device_mesh, set_active_mesh
    from speech_recognition_tpu_torch.parallel.expert import expert_parallel_moe

    out = {}
    for name, (k, cap, dp, mp, params, x) in cases.items():
        mesh = get_device_mesh(dp, mp, "cpu")
        try:
            n = x.shape[0] // dp
            lo, el = mesh.data_index * n, E // mp
            local = {key: torch.tensor(v if key == "router" else v[mesh.model_index * el : (mesh.model_index + 1) * el],
                                       requires_grad=True) for key, v in params.items()}
            xl = torch.tensor(x[lo : lo + n], requires_grad=True)
            result = {}
            for objective in ("y", "aux"):
                y, aux = expert_parallel_moe(local, xl, mesh, k=k, cap=cap)
                (y.pow(2).sum() if objective == "y" else aux).backward()
                grads = {key: torch.zeros_like(t) if t.grad is None else t.grad.clone() for key, t in local.items()}
                for g in grads.values():  # each data position's share of the objective
                    dist.all_reduce(g, group=mesh.data_group)
                result[objective] = {"y": y.detach().numpy(), "aux": float(aux), "x": xl.grad.numpy().copy(),
                                     **{key: g.numpy() for key, g in grads.items()}}
                for t in (*local.values(), xl):
                    t.grad = None
            out[name] = result
        finally:
            set_active_mesh(None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    rng = np.random.default_rng(5)
    ep = {name: (k, cap, dp, mp, ep_params(i), rng.normal(size=(16, D)).astype(np.float32))
          for i, (name, (k, cap, dp, mp)) in enumerate(EP_CASES.items())}
    tp_names = ["las", "ds2", "transducer", "moe", "moe_free"]
    tmp = tmp_path_factory.mktemp("tp")
    two = run_ranks(specs_worker, 2, tmp, [dict(cases[n][0], dp=1, mp=2) for n in tp_names])
    four = run_ranks(specs_worker, 4, tmp, [dict(cases[n][0], dp=2, mp=2) for n in tp_names])
    ep2 = run_ranks(ep_worker, 2, tmp, {n: c for n, c in ep.items() if c[2] * c[3] == 2})
    ep4 = run_ranks(ep_worker, 4, tmp, {n: c for n, c in ep.items() if c[2] * c[3] == 4})
    return {"cases": cases, "ep": ep,
            "tp": {(1, 2): {n: [r[i] for r in two] for i, n in enumerate(tp_names)},
                   (2, 2): {n: [r[i] for r in four] for i, n in enumerate(tp_names)}},
            "ep_runs": {**{n: ep2 for n in ep if ep[n][2] * ep[n][3] == 2},
                        **{n: ep4 for n in ep if ep[n][2] * ep[n][3] == 4}}}


MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["las", "ds2", "transducer", "moe_free"])
def test_model_parallel_matches_one_process(runs, mesh, name):
    got = runs["tp"][mesh][name]
    for other in got[1:]:
        assert other["metrics"] == got[0]["metrics"]
        for key, value in got[0]["state"].items():
            np.testing.assert_array_equal(other["state"][key], value, err_msg=key)
    assert_runs_match(got[0], train_steps(runs["cases"][name][0]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["las", "ds2", "transducer", "moe"])
def test_model_parallel_matches_jax_tensor_parallel(runs, mesh, name):
    spec, model, kwargs = runs["cases"][name]
    want = jax_steps(model, spec["variables"], spec["batches"], dp=mesh[0], mp=mesh[1], tensor_parallel=True, **kwargs)
    assert_runs_match(runs["tp"][mesh][name][0], want)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_expert_parallel_moe_matches_jax(runs, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from speech_recognition_tpu.parallel.expert import expert_parallel_moe

    k, cap, dp, mp, params, x = runs["ep"][name]
    ranks = runs["ep_runs"][name]
    mesh = Mesh(np.asarray(jax.devices()[: dp * mp]).reshape(dp, mp), ("data", "model"))
    j_params = jax.tree_util.tree_map(jnp.asarray, params)

    def fn(p, xx):
        return expert_parallel_moe(p, xx, mesh, expert_axis="model", data_axis="data" if dp > 1 else None, k=k,
                                   capacity=cap)

    y, aux = jax.jit(fn)(j_params, jnp.asarray(x))
    grads = {"y": jax.jit(jax.grad(lambda p, xx: jnp.sum(fn(p, xx)[0] ** 2), argnums=(0, 1)))(j_params, jnp.asarray(x)),
             "aux": jax.jit(jax.grad(lambda p, xx: fn(p, xx)[1], argnums=(0, 1)))(j_params, jnp.asarray(x))}
    tol = dict(rtol=1e-5, atol=1e-6)
    lead = [ranks[d * mp][name] for d in range(dp)]  # model index 0 of each data position
    np.testing.assert_allclose(np.concatenate([r["y"]["y"] for r in lead]), np.asarray(y), **tol)
    np.testing.assert_allclose(sum(r["y"]["aux"] for r in lead), float(aux), **tol)
    for objective, (gp, gx) in grads.items():
        np.testing.assert_allclose(np.concatenate([r[objective]["x"] for r in lead]), np.asarray(gx), **tol)
        np.testing.assert_allclose(lead[0][objective]["router"], np.asarray(gp["router"]), **tol)
        for key in ("w_in", "b_in", "w_out", "b_out"):
            whole = np.concatenate([ranks[m][name][objective][key] for m in range(mp)])
            np.testing.assert_allclose(whole, np.asarray(gp[key]), err_msg=f"{objective} {key}", **tol)
    if cap == 2:  # binding: the per-shard routing must actually drop tokens here
        from speech_recognition_tpu.parallel.expert import moe_ffn

        free, _ = moe_ffn(j_params, jnp.asarray(x), k=k, capacity=16)
        assert not np.allclose(np.asarray(y), np.asarray(free))
