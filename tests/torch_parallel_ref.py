"""The JAX side of the port's parallel tests (tests/test_torch_parallel_*.py): seeded
mini-config variables, batches, and JAX's train step on a mesh of the virtual CPU
devices (``tests/conftest.py`` gives the test process 8).  JAX is imported inside
the functions only: a spawned port rank imports nothing of it.
"""

import numpy as np

FREQ, CHANNELS, FRAMES = 40, 3, 60


def jax_variables(config_path, seed=0, tokens=None, **overrides):
    """(flax model, numpy {"params", "batch_stats"}) of a mini config with ``overrides``.
    The weights are the port's initializers' (``weights.params_to_jax``, much quicker
    than a Flax init) with the biases and batch statistics perturbed from a numpy
    seed, so that every leaf carries a non-trivial value.  ``tokens`` is unused (the
    token-conditioned models need no dummy input here)."""
    import dataclasses

    import torch

    from speech_recognition_tpu.configs import get_model_config as jax_model_config
    from speech_recognition_tpu_torch.configs import get_model_config
    from speech_recognition_tpu_torch.run.common import _MODELS
    from speech_recognition_tpu_torch.weights import params_to_jax

    model = jax_model_config(config_path).create_model().clone(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items()})
    config = dataclasses.replace(get_model_config(config_path), **overrides)
    port = _MODELS[type(config)](config, FREQ, CHANNELS, generator=torch.Generator().manual_seed(seed))
    variables = params_to_jax(port.state_dict())
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                perturb(value)
            elif name in ("bias", "joint_bias", "b_in", "b_out"):
                tree[name] = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
            elif name == "mean":
                tree[name] = rng.normal(0.0, 0.2, value.shape).astype(np.float32)
            elif name == "var":
                tree[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    perturb(variables)
    return model, variables


def audio_batch(rng, batch):
    """Clips of different lengths (zero past each), with their frame counts."""
    audio = rng.uniform(0.0, 5.0, (batch, FRAMES, FREQ, CHANNELS)).astype(np.float32)
    lengths = rng.integers(20, FRAMES + 1, batch).astype(np.int32)
    lengths[0] = FRAMES
    for b, n in enumerate(lengths):
        audio[b, n:] = 0.0
    return audio, lengths


def ctc_batches(seed, n, batch=4, vocab=16000):
    """``n`` (audio, lengths), tokens batches for a CTC model; row 0 has pad labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        audio, lengths = audio_batch(rng, batch)
        tokens = rng.integers(1, vocab, (batch, 5)).astype(np.int32)
        tokens[0, 3:] = 0
        out.append(((audio, lengths), tokens))
    return out


def seq_batches(seed, n, batch=4, vocab=16000, length=7, token_counts=None):
    """``n`` ((audio, lengths), tokens[:, :-1]), tokens[:, 1:] batches (LAS, the
    transducer); ``token_counts`` the non-pad tokens of each row (BOS and EOS
    included), so the two halves of a batch can hold different counts."""
    rng = np.random.default_rng(seed)
    counts = token_counts or [length] * batch
    out = []
    for _ in range(n):
        audio, lengths = audio_batch(rng, batch)
        tokens = np.zeros((batch, length), np.int32)
        for b, c in enumerate(counts):
            tokens[b, :c] = [1, *rng.integers(3, vocab, c - 2), 2]
        out.append((((audio, lengths), tokens[:, :-1]), tokens[:, 1:]))
    return out


def jax_steps(model, variables, batches, dp=1, mp=1, tx=None, fsdp=False, tensor_parallel=False, accum=1,
              teacher=False, fsdp_min_size=2**14):
    """JAX's train step over ``batches`` on a ``dp`` x ``mp`` mesh of the CPU devices
    (unsharded at 1 x 1): {"metrics": per step, "state": the port's state_dict layout}."""
    import jax
    import jax.numpy as jnp
    import optax

    from speech_recognition_tpu.parallel import get_device_mesh, set_active_mesh, shard_batch, shard_params
    from speech_recognition_tpu.train import TrainState, linear_warmup_decay, make_train_step
    from speech_recognition_tpu_torch.weights import params_from_jax

    tx = tx or optax.adam(linear_warmup_decay(10, 1e-3, 1e-5, 0.0, 2), eps=1e-7)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    mesh = None
    try:
        if dp * mp > 1:
            mesh = get_device_mesh(data_parallel=dp, model_parallel=mp, devices=jax.devices()[: dp * mp])
            state = state.replace(
                params=shard_params(state.params, mesh, tensor_parallel=tensor_parallel, fsdp=fsdp,
                                    fsdp_min_size=fsdp_min_size),
                batch_stats=shard_params(state.batch_stats, mesh),
                opt_state=shard_params(state.opt_state, mesh, tensor_parallel=tensor_parallel, fsdp=fsdp,
                                       fsdp_min_size=fsdp_min_size),
            )
        step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=teacher)
        metrics = []
        put = (lambda x: shard_batch(x, mesh)) if mesh is not None else (lambda x: x)
        for k, (model_input, y_true) in enumerate(batches):
            j_in = jax.tree_util.tree_map(jnp.asarray, model_input)
            state, m = step(state, put(j_in), put(jnp.asarray(y_true)), jax.random.PRNGKey(k))
            metrics.append({key: float(v) for key, v in m.items()})
        variables_out = jax.tree_util.tree_map(np.asarray, jax.device_get(state.variables))
    finally:
        set_active_mesh(None)
    sd = params_from_jax(variables_out)
    return {"metrics": metrics, "state": {k: v.numpy() for k, v in sd.items()}}
