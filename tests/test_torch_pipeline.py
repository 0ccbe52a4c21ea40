"""GPipe (speech_recognition_tpu_torch/parallel/pipeline.py) against the JAX package's
``gpipe`` (tests/test_pipeline_parallel.py's cases), on the CPU.

The port's stages run on ``[cpu] * S``; JAX's over ``S`` of the 8 virtual CPU
devices, on the same numpy-seeded weights and inputs.

- Dense tanh stacks (4 layers, width 8, B=16) at (S, M) = (2, 4) and (4, 8):
  the outputs within rtol 1e-5 / atol 1e-6 of JAX's gpipe and of the port's
  sequential stack.
- Gradients at (4, 8) of ``sum(y ** 2)`` for every weight, bias and the input:
  loss rtol 1e-5, gradients rtol 1e-5 / atol 1e-6 against JAX's and against the
  port's sequential stack's.
- The DS2-style BiGRU trunk (2 port ``BiGRU`` layers, 4 units, width 8, B=8,
  T=6, a frame mask as ``const``) at (2, 4): rtol / atol 1e-5 against JAX's
  gpipe over its ``BiRNN`` and against the sequential stack; each layer's
  forward runs once per microbatch (no fill or drain work).
- Each stage runs with its own device current (the device guard, recorded).
- The validation messages of JAX's (``not divisible``, ``n_micro``).
- The composition with data parallelism as one 2-rank gloo job
  (``tests/torch_ranks.py pipeline_dp_worker``): each rank pipelines its rows
  (S=4, M=4) and the gradients are summed over ``data``; the rows' outputs
  and the summed gradients within rtol 1e-5 / atol 1e-6 of JAX's gpipe with
  ``data_axis="data"`` on a 2 x 4 mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from speech_recognition_tpu.ops.rnn import BiRNN as JaxBiRNN
from speech_recognition_tpu.parallel.pipeline import gpipe as jax_gpipe
from speech_recognition_tpu.parallel.pipeline import stack_params as jax_stack_params
from speech_recognition_tpu.parallel.pipeline import stack_stage_fn as jax_stack_stage_fn
from speech_recognition_tpu_torch.ops.rnn import BiGRU
from speech_recognition_tpu_torch.parallel import gpipe, stack_params, stack_stage_fn
from speech_recognition_tpu_torch.weights import params_to_jax

from .test_torch_twins import no_registered_mesh  # noqa: F401  (autouse fixture)
from .torch_ranks import dense_layer, pipeline_dp_worker, run_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")


def _jax_dense(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _dense_stack(seed, n_layers=4, width=8):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(width, width)) / np.sqrt(width)).astype(np.float32),
             "b": (rng.normal(size=(width,)) * 0.1).astype(np.float32)} for _ in range(n_layers)]


def _torch_layers(layers):
    return [{k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()} for layer in layers]


def _jax_mesh(n_pipe, n_data=1):
    devices = np.asarray(jax.devices()[:n_pipe * n_data])
    if n_data > 1:
        return Mesh(devices.reshape(n_data, n_pipe), ("data", "pipe"))
    return Mesh(devices, ("pipe",))


def _sequential(layer_fn, layers, x, *const):
    for p in layers:
        x = layer_fn(p, x, *const)
    return x


@pytest.mark.parametrize("n_pipe,n_micro", [(2, 4), (4, 8)])
def test_gpipe_dense_stack_matches_jax_and_sequential(n_pipe, n_micro):
    layers = _dense_stack(0)
    x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_gpipe(jax_stack_stage_fn(_jax_dense), p, x, n_micro, _jax_mesh(n_pipe)))(
        jax_stack_params(layers, n_pipe), x)
    params = _torch_layers(layers)
    with torch.no_grad():
        got = gpipe(stack_stage_fn(dense_layer), stack_params(params, n_pipe), torch.from_numpy(x), n_micro,
                    [CPU] * n_pipe)
        seq = _sequential(dense_layer, params, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)


def test_gpipe_gradients_match_jax_and_sequential():
    n_pipe, n_micro = 4, 8
    layers = _dense_stack(2)
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    mesh = _jax_mesh(n_pipe)

    def loss_pipe(p, x):
        return jnp.sum(jax_gpipe(jax_stack_stage_fn(_jax_dense), p, x, n_micro, mesh) ** 2)

    j_loss, (j_gp, j_gx) = jax.jit(jax.value_and_grad(loss_pipe, argnums=(0, 1)))(jax_stack_params(layers, n_pipe), x)

    def port(pipelined):
        params = _torch_layers(layers)
        xt = torch.from_numpy(x).requires_grad_()
        if pipelined:
            y = gpipe(stack_stage_fn(dense_layer), stack_params(params, n_pipe), xt, n_micro, [CPU] * n_pipe)
        else:
            y = _sequential(dense_layer, params, xt)
        loss = (y ** 2).sum()
        grads = torch.autograd.grad(loss, [xt] + [p[k] for p in params for k in ("w", "b")])
        return loss.item(), [g.numpy() for g in grads]

    loss, grads = port(True)
    seq_loss, seq_grads = port(False)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(loss, seq_loss, rtol=1e-5)
    per_stage = len(layers) // n_pipe
    want = [np.asarray(j_gx)] + [np.asarray(j_gp[k][s, i]) for s in range(n_pipe) for i in range(per_stage)
                                 for k in ("w", "b")]
    for g, w, s in zip(grads, want, seq_grads):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, s, **TOL)


def test_gpipe_birnn_trunk_matches_jax_and_sequential(monkeypatch):
    """A DS2-style homogeneous BiGRU trunk: width == 2 * units, so every layer maps [B, T, 2H] -> [B, T, 2H]."""
    import speech_recognition_tpu_torch.ops.rnn as rnn_mod

    units, width, B, T = 4, 8, 8, 6
    n_pipe, n_micro = 2, 4
    gen = torch.Generator().manual_seed(6)
    layers = [BiGRU(width, units) for _ in range(2)]
    with torch.no_grad():
        for layer in layers:
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    x = np.random.default_rng(6).normal(size=(B, T, width)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([6, 5, 4, 6, 3, 6, 2, 6])[:, None]

    module = JaxBiRNN("gru", units)
    jax_layers = [params_to_jax(layer.state_dict())["params"] for layer in layers]
    jax_layer = lambda params, h, m: module.apply({"params": params}, h, m)[0]
    want = jax.jit(lambda p, x, m: jax_gpipe(jax_stack_stage_fn(jax_layer), p, x, n_micro, _jax_mesh(n_pipe),
                                             const=(m,)))(jax_stack_params(jax_layers, n_pipe), x, mask)

    calls = []
    scan = rnn_mod.gru_scan
    monkeypatch.setattr(rnn_mod, "gru_scan", lambda *a: calls.append(a[0].shape[2]) or scan(*a))
    layer_fn = lambda layer, h, m: layer(h, m)[0]
    with torch.no_grad():
        got = gpipe(stack_stage_fn(layer_fn), stack_params(layers, n_pipe), torch.from_numpy(x), n_micro,
                    [CPU] * n_pipe, const=(torch.from_numpy(mask),))
        assert calls == [B // n_micro] * (len(layers) * n_micro)  # each layer once per microbatch
        seq = _sequential(layer_fn, layers, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)


def test_gpipe_runs_each_stage_on_its_device(monkeypatch):
    """Stage s runs with ``devices[s]`` current (``kernels.device_scope``, recorded here), forward and
    backward: a kernel's entry point and the BiGRU's CUDA graph capture take the current device, not
    their operands'; each stage once per microbatch."""
    import contextlib

    import speech_recognition_tpu_torch.parallel.pipeline as pipeline

    n_pipe, n_micro = 3, 4
    current, seen = [None], []

    @contextlib.contextmanager
    def scope(dev):
        prev, current[0] = current[0], dev
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(pipeline, "device_scope", scope)
    devices = [torch.device("cpu", s) for s in range(n_pipe)]
    weights = [{"s": s, "w": torch.full((4,), 0.5 + s, requires_grad=True)} for s in range(n_pipe)]

    def stage_fn(params, x):
        seen.append((params["s"], current[0]))
        return torch.tanh(x * params["w"])

    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(8))
    y = gpipe(stage_fn, weights, x, n_micro, devices)
    (y ** 2).sum().backward()
    assert sorted(seen) == sorted((s, devices[s]) for s in range(n_pipe) for _ in range(n_micro))
    assert current[0] is None and all(w["w"].grad is not None for w in weights)


def test_gpipe_validates_microbatching():
    layers = _dense_stack(7, 2, 4)
    stages = stack_params(_torch_layers(layers), 2)
    x = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="not divisible"):
        gpipe(stack_stage_fn(dense_layer), stages, x, 4, [CPU] * 2)
    with pytest.raises(ValueError, match="n_micro"):
        gpipe(stack_stage_fn(dense_layer), stages, x, 1, [CPU] * 2)
    with pytest.raises(ValueError, match="not divisible"):
        stack_params(layers, 4)
    # JAX's messages, word for word
    mesh = _jax_mesh(2)
    for call, n in ((lambda: gpipe(stack_stage_fn(dense_layer), stages, x, 4, [CPU] * 2), 4),
                    (lambda: gpipe(stack_stage_fn(dense_layer), stages, x, 1, [CPU] * 2), 1)):
        with pytest.raises(ValueError) as port_err:
            call()
        with pytest.raises(ValueError) as jax_err:
            jax_gpipe(jax_stack_stage_fn(_jax_dense), jax_stack_params(layers, 2), jnp.zeros((6, 4)), n, mesh)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        jax_stack_params(layers, 4)
    with pytest.raises(ValueError) as port_err:
        stack_params(layers, 4)
    assert str(port_err.value) == str(jax_err.value)


def test_gpipe_composes_with_data_parallel(tmp_path):
    n_data, n_pipe, n_micro = 2, 4, 4
    layers = _dense_stack(4)
    x = np.random.default_rng(5).normal(size=(16, 8)).astype(np.float32)
    mesh = _jax_mesh(n_pipe, n_data)

    def loss(p, x):
        y = jax_gpipe(jax_stack_stage_fn(_jax_dense), p, x, n_micro, mesh, data_axis="data")
        return jnp.sum(y ** 2), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jax_stack_params(layers, n_pipe), x)
    ranks = run_ranks(pipeline_dp_worker, n_data, tmp_path, layers, x, n_pipe, n_micro)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), np.asarray(want), **TOL)
    per_stage = len(layers) // n_pipe
    want_grads = [np.asarray(grads[k][s, i]) for s in range(n_pipe) for i in range(per_stage) for k in ("w", "b")]
    for r in ranks:
        for g, w in zip(r["grads"], want_grads):
            np.testing.assert_allclose(g, w, **TOL)
