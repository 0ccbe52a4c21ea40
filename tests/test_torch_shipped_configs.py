"""Every shipped model config against the port's kernel launch checks, on the CPU.

At each config's main-path shapes (B = 128 clips of 1024 frames under
``resources/configs/libri_config.yml``: labels of at most 128 tokens, so
N = 127 teacher-forced steps and L = 128 decode steps) every kernel the
config's training, dev pass and decodes launch must pass its wrapper's shape
and shared-memory checks: K10's width limit (``rnn_plan``), K11's step kernel
for beam-8 (``beams_per_block``: a block's shared memory within
``SMEM_LIMIT``), the vocab tile pass (``tile_plan``: K1, K4, K5, K6, K11's
vocab step, the TSD beam), the backward engine (``bwd_plan``: K1, K6, K8,
K9), K7 (``mhsa_plan``) and the joint forward (``joint_fwd_plan``: K8, K9).
``deepspeech_moe.yml`` adds the MoE trunk's dispatch buffers (``models/moe.py``:
capacity C = 2160 of the 13,824 tokens per layer).  Each
config's no-grad recurrent layers in bf16 take the K10 route their width
gives: the cluster tensor-core route up to H = 384 (its launch within the
card's limits), the narrow route's clusters at ``las_medium.yml``'s 512, the persistent
grid at ``las_large.yml``'s 1024.
"""

import dataclasses
import glob
import os

import pytest
import torch

from speech_recognition_tpu_torch.configs import (ConformerConfig, DataConfig, DeepSpeechConfig, LASConfig,
                                                  TransducerConfig, get_model_config)
from speech_recognition_tpu_torch.models.moe import capacity
from speech_recognition_tpu_torch.ops.attention import ROUTE_TENSOR_CORE, mhsa_plan
from speech_recognition_tpu_torch.ops.beam_search import SMEM_LIMIT, beams_per_block, step_smem_bytes
from speech_recognition_tpu_torch.ops.joint_planes import MAX_J, ROUTE_TILE_PASS, joint_fwd_plan
from speech_recognition_tpu_torch.ops.rnn_sequence import MAX_UNITS, TC_MAX_CLUSTER, TC_MAX_K, cluster_tc_smem, rnn_plan
from speech_recognition_tpu_torch.ops.vocab_bwd import bwd_plan
from speech_recognition_tpu_torch.ops.vocab_topk import tile_plan, tile_smem
from speech_recognition_tpu_torch.run.common import create_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "resources", "configs")
MODEL_CONFIGS = ["conformer_small.yml", "deepspeech.yml", "deepspeech_moe.yml", "las_large.yml", "las_medium.yml",
                 "las_small.yml", "transducer_small.yml", "transducer_small_dense.yml", "transducer_small_pruned.yml"]
B, FRAMES, BEAM, TSD_ROUNDS_K = 128, 1024, 8, 8 + 3  # the TSD beam's joint rounds take the top-(beam + 3)


def data_config():
    return DataConfig.from_yaml(os.path.join(CONFIGS, "libri_config.yml"))


def valid_frames(T, kernels, strides):
    for k, s in zip(kernels, strides):
        T = (T - k) // s + 1
    return T


def test_the_lists_name_every_shipped_model_config():
    model = []
    for path in sorted(glob.glob(os.path.join(CONFIGS, "*.yml"))):
        with open(path) as f:
            if "model_name" in f.read():
                model.append(os.path.basename(path))
    assert sorted(MODEL_CONFIGS) == model


def check_recurrent(rnn_type, H):
    """K10 takes the width, in both compute types."""
    assert H <= MAX_UNITS
    for dtype in (torch.bfloat16, torch.float32):
        assert rnn_plan(rnn_type, H, dtype, D=2, B=B).route in ("cluster_tc", "narrow", "wide", "persistent")


def check_las(cfg, L):
    T, V = valid_frames(FRAMES, (3, 3), (2, 2)), cfg.vocab_size  # the listener's two 3x3 stride-2 convs: 255
    He, Hd = cfg.encoder_hidden_dim, cfg.decoder_hidden_dim
    check_recurrent("lstm", He)  # the listener: decode and dev pass
    Dv = 2 * He
    kb = beams_per_block(BEAM, T, Hd, Hd, Dv)  # K11's step kernel, the embedding as wide as the decoder
    assert kb in (1, 2, 4, 8) and step_smem_bytes(kb, T, Hd, Hd, Dv) <= SMEM_LIMIT
    for R, k in ((B, 1), (B, BEAM), (B * BEAM, BEAM), ((L - 1) * B, 1)):  # K4, K5's first step, K11's vocab, K1
        tile_plan(R, Hd, V, k)
    bwd_plan((L - 1) * B, Hd, V)  # K1's backward


def check_ctc(R, H, V):
    tile_plan(R, H, V, 1)  # K6's forward
    bwd_plan(R, H, V)  # K6's backward


def check_encoder(heads, width):
    plan = mhsa_plan(B, 256, heads, width // heads, torch.bfloat16)  # 255 frames after the stem, 256 in the blocks
    assert plan.route == ROUTE_TENSOR_CORE and max(plan.fwd_smem, plan.dq_smem, plan.dkv_smem) <= SMEM_LIMIT


def check_transducer(cfg, L):
    T, J, V = 255, cfg.joint_dim, cfg.vocab_size
    check_encoder(cfg.num_attention_heads, cfg.encoder_dim)
    check_recurrent("lstm", cfg.pred_dim)  # the prediction net's dev pass
    S = cfg.pruned_range or L - 1  # the band, or every label slot: U + 1 = 127 (chip_smoke.py U1_RNNT)
    R = B * T * S
    assert J <= MAX_J and R < 2 ** 31
    plan = joint_fwd_plan(R, J, V, torch.bfloat16)
    assert plan.route == ROUTE_TILE_PASS and tile_smem(-(-J // 64), plan.wgs, plan.stage_k) <= SMEM_LIMIT
    bwd_plan(R, J, V)
    tile_plan(B * BEAM, J, V, TSD_ROUNDS_K)  # the TSD beam's joint rounds through K5


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_shipped_config_passes_every_kernel_check(name):
    cfg = get_model_config(os.path.join(CONFIGS, name))
    L = data_config().max_token_length
    if isinstance(cfg, LASConfig):
        check_las(cfg, L)
    elif isinstance(cfg, DeepSpeechConfig):
        T = valid_frames(FRAMES, [k[0] for k in cfg.kernel_sizes], [s[0] for s in cfg.strides])
        assert T == 108
        check_recurrent(cfg.rnn_type, cfg.hidden_dim)
        check_ctc(B * T, 2 * cfg.hidden_dim, cfg.vocab_size)
        if cfg.moe_experts:
            check_moe(cfg, B * T)
    elif isinstance(cfg, ConformerConfig):
        check_encoder(cfg.num_attention_heads, cfg.encoder_dim)
        check_ctc(B * 255, cfg.encoder_dim, cfg.vocab_size)
    else:
        assert isinstance(cfg, TransducerConfig)
        check_transducer(cfg, L)


def check_moe(cfg, n_tokens):
    """The index form's buffers at the main path's shape: [E, C, 2H] dispatch, [E, C, hidden] activations."""
    C = capacity(n_tokens, cfg.moe_experts, cfg.moe_k, cfg.moe_capacity_factor)
    hidden = cfg.moe_hidden_dim or 8 * cfg.hidden_dim
    assert cfg.moe_experts * C >= n_tokens * cfg.moe_k and C <= n_tokens
    assert cfg.moe_experts * C * hidden * 2 < 2 ** 31  # the bf16 activations of a layer's experts, in bytes


def test_moe_config_builds_its_trunk():
    cfg = get_model_config(os.path.join(CONFIGS, "deepspeech_moe.yml"))
    assert capacity(B * 108, cfg.moe_experts, cfg.moe_k, cfg.moe_capacity_factor) == 2160
    small = dataclasses.replace(cfg, hidden_dim=8, moe_hidden_dim=16, vocab_size=32, channels=[2, 2, 2])
    model = create_model(small, data_config(), torch.float32, torch.device("cpu"))
    layers = [k for k in model.state_dict() if ".moe" in k]
    assert len(layers) == 5 * cfg.num_reccurent_layers and model.recurrent.moe6.w_in.shape == (8, 16, 16)


def test_las_large_needs_the_wide_recurrent_route_and_split_beam_blocks():
    """LAS-large (H = 1024) is what K10's routes above H = 512 (bf16: the persistent grid of 2 x 64 CTAs, one
    an SM of the H100's 132, R resident; float32: the wide clusters) and K11's beams-per-block split exist for."""
    cfg = get_model_config(os.path.join(CONFIGS, "las_large.yml"))
    plan = rnn_plan("lstm", cfg.encoder_hidden_dim, torch.bfloat16, D=2, B=B)
    assert plan.route == "persistent" and 2 * plan.ctas == 128 and plan.slice_rows == B
    assert rnn_plan("lstm", cfg.encoder_hidden_dim, torch.float32, D=2, B=B).route == "wide"
    assert step_smem_bytes(BEAM, 255, 1024, 1024, 2048) == 327680 > SMEM_LIMIT
    assert beams_per_block(BEAM, 255, 1024, 1024, 2048) == 4
    small = get_model_config(os.path.join(CONFIGS, "las_small.yml"))
    assert rnn_plan("lstm", small.encoder_hidden_dim, torch.bfloat16).route == "cluster_tc"
    assert beams_per_block(BEAM, 255, 256, 256, 512) == BEAM  # one block per batch row, as before


def recurrent_layers(cfg):
    """(cell, width, directions) of the config's no-grad recurrent layers: the LAS listener, DS2's BiGRU, the
    transducer's prediction net; none for the Conformer."""
    if isinstance(cfg, LASConfig):
        return [("lstm", cfg.encoder_hidden_dim, 2)]
    if isinstance(cfg, DeepSpeechConfig):
        return [(cfg.rnn_type, cfg.hidden_dim, 2)]
    if isinstance(cfg, TransducerConfig):
        return [("lstm", cfg.pred_dim, 1)]
    return []


RECURRENT_CONFIGS = ["deepspeech.yml", "deepspeech_moe.yml", "las_large.yml", "las_medium.yml", "las_small.yml",
                     "transducer_small.yml", "transducer_small_dense.yml", "transducer_small_pruned.yml"]


def test_the_recurrent_list_names_every_config_with_recurrent_layers():
    assert RECURRENT_CONFIGS == [n for n in MODEL_CONFIGS
                                 if recurrent_layers(get_model_config(os.path.join(CONFIGS, n)))]


@pytest.mark.parametrize("name", RECURRENT_CONFIGS)
def test_shipped_recurrent_widths_take_their_k10_route(name):
    """bf16 at B = 128: the cluster tensor-core route up to H = 384 (clusters of at most 16 CTAs owning ceil(H /
    16) units each, rounded up to 8; K within six k-panels; shared memory within the H100's), the narrow route's
    clusters from 385 to 512, the persistent grid above."""
    for rnn_type, H, D in recurrent_layers(get_model_config(os.path.join(CONFIGS, name))):
        plan = rnn_plan(rnn_type, H, torch.bfloat16, D=D, B=B)
        if H > 512:
            assert plan.route == "persistent"
        elif H > 384:
            assert plan.route == "narrow"
        else:
            K = -(-plan.cluster * plan.units // 16) * 16
            assert plan.route == "cluster_tc" and plan.cluster <= TC_MAX_CLUSTER and K <= TC_MAX_K
            assert plan.cluster * plan.units >= H and plan.smem == cluster_tc_smem(rnn_type, plan.units, K,
                                                                                    plan.stages) <= SMEM_LIMIT
