"""Spawned gloo ranks for the port's parallel tests (tests/test_torch_parallel_*.py).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes (spawn),
each joining a gloo job through a ``file://`` store under ``tmp_path`` (no
port, so parallel test workers never collide), runs ``fn(rank, world,
*args)`` and returns each rank's result; every rank runs under its own
timeout, and a rank that fails or hangs fails the call.  Nothing here imports
JAX: a spawned rank imports this module and the port only.

``train_steps(spec, mesh)`` runs the port's train step on a model built from
numpy variables, on every rank the same global batches (each rank takes its
``data`` position's rows), under the mesh's data, tensor, expert or FSDP
parallelism; with ``mesh=None`` it is the one-process run of the same spec.
"""

import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT = 120.0


def _entry(fn, rank, world, store, out, args):
    import torch.distributed as dist

    from speech_recognition_tpu_torch.parallel import init_process_group

    torch.set_num_threads(1)
    try:
        init_process_group(f"file://{store}", world, rank, "CPU")
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save({"ok": result}, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        torch.save({"error": traceback.format_exc()}, os.path.join(out, f"rank{rank}.pt"))
        raise


def run_ranks(fn, world, tmp_path, *args, timeout: float = RANK_TIMEOUT):
    """``[fn(rank, world, *args) for rank in range(world)]``, one spawned gloo process each."""
    out = str(tmp_path / f"ranks_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(out)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, os.path.join(out, "store"), out, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, hung = [], []
    for r, p in enumerate(procs):
        p.join(timeout)
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    for r in range(world):
        path = os.path.join(out, f"rank{r}.pt")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} left no result (hung ranks: {hung}, exit codes: "
                               f"{[p.exitcode for p in procs]})")
        got = torch.load(path, weights_only=False)
        if "error" in got:
            raise RuntimeError(f"rank {r} failed:\n{got['error']}")
        results.append(got["ok"])
    return results


# ------------------------------------------------------------------ training


def build_model(spec):
    """The port's model of ``spec["config"]`` (a model-config path, fields
    overridden by ``spec["overrides"]``) with ``spec["variables"]`` (Flax numpy tree)."""
    import dataclasses

    from speech_recognition_tpu_torch.configs import get_model_config
    from speech_recognition_tpu_torch.models import LAS, Conformer, DeepSpeech2, Transducer
    from speech_recognition_tpu_torch.weights import params_from_jax

    config = dataclasses.replace(get_model_config(spec["config"]), **spec.get("overrides", {}))
    family = {"las": LAS, "ds2": DeepSpeech2, "conformer": Conformer, "transducer": Transducer}[spec["family"]]
    model = family(config, spec["freq"], spec["channels"])
    model.load_state_dict(params_from_jax(spec["variables"]))
    return model.train(True)


def _rows(batch, lo, n):
    """Rows [lo, lo + n) of every array of a nested batch, as torch tensors."""
    if isinstance(batch, (tuple, list)):
        return tuple(_rows(b, lo, n) for b in batch)
    return torch.from_numpy(np.ascontiguousarray(batch[lo : lo + n]))


def train_steps(spec, mesh=None):
    """Run ``spec["batches"]`` through the port's train step; returns the
    per-step metrics and the final whole state_dict (numpy)."""
    from speech_recognition_tpu_torch.parallel.shard import (apply_fsdp, full_state_dict, shard_experts,
                                                              shard_tensor_parallel)
    from speech_recognition_tpu_torch.train import TrainState, linear_warmup_decay, make_adam, make_train_step
    from speech_recognition_tpu_torch.train.state import LossRoute

    torch.manual_seed(0)
    model = build_model(spec)
    route, fsdp_params = None, set()
    if mesh is not None:
        shard_tensor_parallel(model, mesh)
        shard_experts(model, mesh)
        if spec.get("fsdp"):
            route = LossRoute(model, model.get_loss_fn(), model.get_metrics())
            fsdp_params = apply_fsdp(route, model, mesh, spec.get("fsdp_min_size", 2**14))
    schedule = linear_warmup_decay(*spec.get("schedule", (10, 1e-3, 1e-5, 0.0, 2)))
    optimizer = make_adam(model, schedule)
    if spec.get("sgd"):  # plain SGD: Adam's sign-like update would magnify reduction-order noise
        optimizer = torch.optim.SGD([{"params": g["params"]} for g in optimizer.param_groups], lr=spec["sgd"])
        schedule = lambda step: spec["sgd"]
    state = TrainState(model, optimizer, schedule, accum_steps=spec.get("accum", 1), mesh=mesh, route=route,
                       fsdp_params=fsdp_params)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    seed = spec.get("seed", 0)
    gen, coin = torch.Generator().manual_seed(seed + 1), torch.Generator().manual_seed(seed + 2)
    dp = 1 if mesh is None else mesh.data
    metrics = []
    for model_input, y_true in spec["batches"]:
        n = len(y_true) // dp
        lo = 0 if mesh is None else mesh.data_index * n
        got = step(state, _rows(model_input, lo, n), _rows(y_true, lo, n), gen, coin)
        metrics.append({k: float(v) for k, v in got.items()})
    whole = full_state_dict(model) if mesh is not None else model.state_dict()
    if spec.get("save") and (mesh is None or torch.distributed.get_rank() == 0):
        from speech_recognition_tpu_torch.train import save_weights

        save_weights(spec["save"], model, whole)
    return {"metrics": metrics, "state": {k: v.detach().cpu().numpy() for k, v in whole.items()}}


def mesh_train_worker(rank, world, spec):
    from speech_recognition_tpu_torch.parallel import get_device_mesh, set_active_mesh

    mesh = get_device_mesh(spec.get("dp"), spec.get("mp", 1), "cpu")
    try:
        return train_steps(spec, mesh)
    finally:
        set_active_mesh(None)


def specs_worker(rank, world, specs):
    """``mesh_train_worker`` over several specs in one job (one process start for all)."""
    return [mesh_train_worker(rank, world, spec) for spec in specs]


# ------------------------------------------------------------- comparisons


def assert_runs_match(got, want, loss_rtol=1e-5, rtol=1e-4, atol=1e-5):
    """Per-step metrics within ``loss_rtol`` and every state_dict entry within rtol / atol."""
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=loss_rtol, err_msg=key)
    assert set(got["state"]) == set(want["state"])
    for key, value in want["state"].items():
        np.testing.assert_allclose(got["state"][key], value, rtol=rtol, atol=atol, err_msg=key)
