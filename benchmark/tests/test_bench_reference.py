"""The plain reference against the port's plain path (the CPU) at a tiny size, in float32: the two
compute the same arithmetic, so every compared number is at rounding."""

import time

import pytest
import torch

import tiny
from benchlib.spec import load_cell


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    return tiny.make_data_dir(root), root + "/bench"


@pytest.mark.parametrize("name,limits", [
    ("las_small.train", {"loss_rel": 1e-5, "grad_leaf": 1e-4, "change_leaf": 1e-3}),
    ("las_large.decode_greedy", {"greedy_logit_gap": 1e-5}),
    ("las_small.decode_beam8", {"beam_logppl_mean_gap": 1e-5, "beam_topk_gap": 1e-5}),
])
def test_reference_agrees_with_the_port(bench, name, limits):
    import run

    cell = load_cell(name, *bench)
    r = run.run_cell(cell, 2 ** 32 + 77, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert r.attempted > 0
    for k, limit in limits.items():
        assert r.readings[k] <= limit, (k, r.readings)


def test_frontend_matches_the_port():
    from reference.las import LASReference
    from speech_recognition_tpu_torch.ops.frontend import make_batch_frontend

    from benchlib import program, traffic, weights

    cfg = tiny.tiny_config()
    pool = traffic.make_pool(tiny.tiny_traffic("libri_decode_greedy"), cfg, 5, torch.device("cpu"))
    ref = LASReference(cfg, weights.make_weights(cfg, 1, torch.device("cpu")))
    for b in pool:
        want, valid = make_batch_frontend(program.data_config(cfg))(b.audio, b.lengths)
        got, frames = ref.frontend(b.audio, b.lengths)
        assert torch.equal(frames, valid)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_weights_fill_the_port_tree():
    from benchlib import program, weights

    cfg = dict(tiny.tiny_config("las_large"))
    w = weights.make_weights(cfg, 3, torch.device("cpu"))
    model = program.build_model(cfg, w, torch.device("cpu"), train=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, w[k])
    assert weights.n_parameters(cfg) == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", ["las_small", "las_large"])
def test_recurrent_kernels_have_orthonormal_rows(name):
    """As the port's ``init_weights`` and Keras's ``orthogonal``: W W^T = I for each [H, 4H] kernel."""
    from benchlib import weights

    cfg = tiny.tiny_config(name)
    w = weights.make_weights(cfg, 2 ** 31 + 3, torch.device("cpu"))
    rk = [v for k, v in w.items() if k.endswith("recurrent_kernel")]
    assert len(rk) == 2 * cfg["num_encoder_layers"] + cfg["num_decoder_layers"]
    for k in rk:
        H = k.shape[0]
        assert k.shape == (H, 4 * H)
        assert torch.allclose(k @ k.t(), torch.eye(H), atol=1e-5)
    assert not torch.equal(rk[0], rk[1])
