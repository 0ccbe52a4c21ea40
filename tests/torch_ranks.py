"""Gloo ranks for the port's parallel tests (tests/test_torch_parallel_*.py).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes (forked
from a fork server that has imported torch and the port), each joining a
gloo job through a ``file://`` store under ``tmp_path`` (no port, so
parallel test workers never collide), runs ``fn(rank, world, *args)`` and
returns each rank's result; every rank runs under its own
timeout, and a rank that fails or hangs fails the call.  Nothing here imports
JAX: a rank imports this module and the port only.

``train_steps(spec, mesh)`` runs the port's train step on a model built from
numpy variables, on every rank the same global batches (each rank takes its
``data`` position's rows), under the mesh's data, tensor, expert or FSDP
parallelism; with ``mesh=None`` it is the one-process run of the same spec.
"""

import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT = 120.0


def _entry(fn, rank, world, store, out, args_path):
    import torch.distributed as dist

    from speech_recognition_tpu_torch.parallel import init_process_group

    torch.set_num_threads(1)
    try:
        args = torch.load(args_path, weights_only=False)
        init_process_group(f"file://{store}", world, rank, "CPU")
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        torch.save({"ok": result}, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        torch.save({"error": traceback.format_exc()}, os.path.join(out, f"rank{rank}.pt"))
        raise


_CTX = None


def _context():
    """The ranks' start method: a fork server that has imported torch, numpy, this module and the
    port's parallel package once per test process (each rank forks from it, where a spawned rank
    would import them anew: ~3 s a rank).  The server listens on a unix socket at
    ``<temp dir>/pymp-XXXXXXXX/listener-XXXXXXXX``, which must fit a socket address (107 bytes);
    under a longer temp dir the ranks are spawned."""
    global _CTX
    if _CTX is None:
        if len(tempfile.gettempdir()) + len("/pymp-XXXXXXXX/listener-XXXXXXXX") <= 107:
            _CTX = mp.get_context("forkserver")
            _CTX.set_forkserver_preload([__name__, "speech_recognition_tpu_torch.parallel"])
        else:
            _CTX = mp.get_context("spawn")
    return _CTX


def run_ranks(fn, world, tmp_path, *args, timeout: float = RANK_TIMEOUT):
    """``[fn(rank, world, *args) for rank in range(world)]``, one gloo process each."""
    out = str(tmp_path / f"ranks_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(out)
    # the arguments go through a file: a new process reads its pickled arguments only once it has started,
    # so a start() handing over more than a pipe holds would wait for it, and the ranks would start one by one
    args_path = os.path.join(out, "args.pt")
    torch.save(args, args_path)
    ctx = _context()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, os.path.join(out, "store"), out, args_path), daemon=True)
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


# ------------------------------------------------- GPipe, sequence parallelism


def dense_layer(params, x):
    """The dense tanh layer of the GPipe tests (tests/test_pipeline_parallel.py ``_dense_layer``)."""
    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_dp_worker(rank, world, layers, x, n_stages, n_micro):
    """One ``data`` rank of GPipe composed with data parallelism: this rank's rows
    of ``x`` through ``gpipe`` over ``[cpu] * n_stages``, and the gradients of the
    global ``sum(y ** 2)`` (each rank's share, summed over ``data`` as the train
    step sums them)."""
    from speech_recognition_tpu_torch.parallel import (data_sum, get_device_mesh, gpipe, set_active_mesh,
                                                       stack_params, stack_stage_fn)

    mesh = get_device_mesh(world, 1, "cpu")
    try:
        params = [{k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()} for layer in layers]
        n = x.shape[0] // world
        rows = torch.from_numpy(x[mesh.data_index * n:(mesh.data_index + 1) * n])
        y = gpipe(stack_stage_fn(dense_layer), stack_params(params, n_stages), rows, n_micro,
                  [torch.device("cpu")] * n_stages)
        grads = torch.autograd.grad((y ** 2).sum(), [p[k] for p in params for k in ("w", "b")])
        return {"y": y.detach().numpy(), "grads": [data_sum(g).numpy() for g in grads]}
    finally:
        set_active_mesh(None)


def sequence_parallel_worker(rank, world, halo, frontends):
    """The sequence-parallel checks of one rank (tests/test_torch_sequence_parallel.py).

    ``halo``: (x [1, T], left, right, cotangent of each rank's extended block):
    this rank's extended block over the world group and its block's gradient.
    ``frontends``: dicts with the data config path, a ``dp`` x ``mp`` mesh, the
    whole batch's ``audio`` / ``lengths``, and optional ``draws`` (numpy fields
    of SpecAugmentDraws for the whole batch) or ``seed`` (a generator's, the same
    on every rank): this rank's rows through ``make_sp_batch_frontend``."""
    import torch.distributed as dist

    from speech_recognition_tpu_torch.configs import DataConfig
    from speech_recognition_tpu_torch.ops.frontend import make_sp_batch_frontend
    from speech_recognition_tpu_torch.ops.spec_augment import SpecAugmentDraws
    from speech_recognition_tpu_torch.parallel import get_device_mesh, halo_exchange, set_active_mesh

    x, left, right, cotangents = halo
    n = x.shape[1] // world
    block = torch.from_numpy(x[:, rank * n:(rank + 1) * n]).requires_grad_()
    ext = halo_exchange(block, dist.group.WORLD, 1, left, right)
    (grad,) = torch.autograd.grad((ext * torch.from_numpy(cotangents[rank])).sum(), block)
    out = {"halo": ext.detach().numpy(), "halo_grad": grad.numpy(), "frontends": []}
    meshes = {}  # one mesh (and its process groups, slow to make) per shape
    for case in frontends:
        shape = (case["dp"], case["mp"])
        if shape not in meshes:
            meshes[shape] = get_device_mesh(*shape, "cpu")
        mesh = meshes[shape]
        set_active_mesh(mesh)
        try:
            cfg = DataConfig.from_yaml(case["config"])
            cfg.spec_augment.W = None  # masks only: the warp's solve is held elsewhere (test_torch_spec_augment.py)
            cfg.spec_augment.enable = cfg.spec_augment.enable or "seed" in case
            B = case["audio"].shape[0] // mesh.data
            lo = mesh.data_index * B
            kwargs = {}
            if "draws" in case:
                kwargs["draws"] = SpecAugmentDraws(**{k: None if v is None else torch.from_numpy(v[lo:lo + B])
                                                      for k, v in case["draws"].items()})
            elif "seed" in case:
                kwargs["generator"] = torch.Generator().manual_seed(case["seed"])
            sp = make_sp_batch_frontend(cfg, mesh, spec_augment=bool(kwargs))
            feats, valid = sp(torch.from_numpy(case["audio"][lo:lo + B]), torch.from_numpy(case["lengths"][lo:lo + B]),
                              **kwargs)
            out["frontends"].append({"feats": feats.numpy(), "valid": valid.numpy(), "rows": (lo, B)})
        finally:
            set_active_mesh(None)
    return out
