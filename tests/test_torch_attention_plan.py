"""K7's launch plan (speech_recognition_tpu_torch/ops/attention.py ``mhsa_plan``), in plain Python on the CPU.

The plan decides what the kernels of ``csrc/attention.cu`` rely on: the route
(bf16 at d = 64 or 128 on the tensor cores, every other case on the CUDA
cores), the forward's passes (one up to T = 256, the whole score row in
registers, two above), the rows and threads of a block, the ring stages,
the grids and the shared memory.  Checked here: the constants mirror the
source's ``constexpr`` values, each route and mode at the shapes that decide
it, grids that cover every query and key row, shared memory within one
block's limit, a resident K / V ring in the one-pass forward, and the C
entries' parameter lists against their ctypes signatures.
"""

import os
import re

import pytest
import torch

from speech_recognition_tpu_torch import kernels
from speech_recognition_tpu_torch.ops import attention as at
from speech_recognition_tpu_torch.ops.vocab_bwd import SMEM_LIMIT, W_PANEL, cdiv

SOURCE = os.path.join(kernels.CSRC, "attention.cu")
T_EDGES = [1, 63, 64, 65, 129, 255, 256, 257, 384, 1000, 4096]
STATIC_SMEM = 8 * (at.MAX_STAGES + 1) + 4 * 4 * at.CHUNK  # the mbarriers, the dk / dv kernel's query values


def _constexprs():
    with open(SOURCE) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r"constexpr int ([^;]+);", src):
        for decl in m.group(1).split(","):
            name, value = decl.split("=")
            out[name.strip()] = int(value.split("//")[0].strip())
    return out


@pytest.mark.parametrize("name", ["CHUNK", "MAX_ND", "MAX_STAGES", "MAX_RESIDENT"])
def test_constants_mirror_the_source(name):
    assert _constexprs()[name] == getattr(at, name)


def test_block_size_mirrors_the_source():
    assert _constexprs()["THREADS"] == at.TC_THREADS


def test_smem_limit_mirrors_the_source():
    assert _constexprs()["MAX_SMEM"] == SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_route_by_dtype_and_head_width(dtype, d):
    plan = at.mhsa_plan(4, 256, 4, d, dtype)
    tensor_core = dtype == torch.bfloat16 and d in (64, 128)
    assert plan.route == (at.ROUTE_TENSOR_CORE if tensor_core else at.ROUTE_CUDA_CORE)
    if tensor_core:
        assert plan.threads == at.TC_THREADS and plan.rows == 64
    else:
        assert plan.threads == 256 and plan.rows == at.CC_TILE and plan.passes == 2
        assert (plan.fwd_smem, plan.dq_smem, plan.dkv_smem) == at.cc_smem(d)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T", T_EDGES)
def test_one_pass_up_to_256_frames_and_two_above(T, d):
    plan = at.mhsa_plan(2, T, 4, d, torch.bfloat16)
    n_chunks = cdiv(T, at.CHUNK)
    assert plan.passes == (1 if T <= at.MAX_RESIDENT * at.CHUNK else 2)
    if plan.passes == 1:  # the head's whole K and V resident: every chunk its own stage
        assert plan.stages >= n_chunks
    # the rings hold every chunk where they can, else stream through all their stages
    assert plan.stages == min(n_chunks, at.MAX_STAGES)


@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 32),
                                      (torch.float32, 64)])
@pytest.mark.parametrize("B, T, H", [(1, 1, 1), (3, 63, 2), (128, 256, 4), (16, 255, 4), (5, 257, 3), (2, 4096, 8)])
def test_grids_cover_every_query_and_key_row(B, T, H, dtype, d):
    plan = at.mhsa_plan(B, T, H, d, dtype)
    assert plan.grid[1:] == (H, B)
    assert (plan.grid[0] - 1) * plan.rows < T <= plan.grid[0] * plan.rows


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T", T_EDGES)
def test_shared_memory_within_one_block(T, d):
    plan = at.mhsa_plan(2, T, 4, d, torch.bfloat16)
    nd = d // 64
    assert plan.fwd_smem == at.tc_smem(nd, 1, plan.stages)
    assert plan.dq_smem == plan.dkv_smem == at.tc_smem(nd, 2, plan.stages)
    assert max(plan.fwd_smem, plan.dq_smem, plan.dkv_smem) + STATIC_SMEM <= SMEM_LIMIT
    # the one-pass forward's ring holds the head's K and V: 2 x T x d bf16 rounded up to whole chunks
    if plan.passes == 1:
        assert plan.stages * 2 * nd * W_PANEL >= 2 * T * d * 2


@pytest.mark.parametrize("blocks", [1, 2])
def test_the_widest_head_fits(blocks):
    assert at.tc_smem(at.MAX_ND, blocks, at.MAX_STAGES) + STATIC_SMEM <= SMEM_LIMIT
    assert max(at.cc_smem(128)) <= SMEM_LIMIT


@pytest.mark.parametrize("B, T, H, d", [(0, 4, 1, 64), (1, 0, 1, 64), (1, 4, 0, 64), (1, 4, 1, 8), (1, 4, 1, 72),
                                        (1, 4, 1, 144)])
def test_plan_rejects_shapes_the_kernels_do_not_take(B, T, H, d):
    with pytest.raises(ValueError):
        at.mhsa_plan(B, T, H, d, torch.bfloat16)


def _c_parameters(name):
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(r"\nint " + name + r"\(([^)]*)\)", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", ["mhsa_fwd", "mhsa_bwd", "mhsa_divide_check"])
def test_c_entries_match_their_ctypes_signatures(name):
    kinds = []
    for p in _c_parameters(name):
        kinds.append(kernels._P if "*" in p else kernels._F if p.startswith("float") else kernels._I)
    assert kinds == kernels._SIGNATURES[name]


def test_cpu_tensors_count_no_tensor_core_launch():
    at.mhsa_fwd.tc_launches = at.mhsa_bwd.tc_launches = 0
    q = torch.randn(2, 70, 128).to(torch.bfloat16)
    bias, seeds = torch.zeros(2, 70), torch.tensor([3, 4], dtype=torch.int32)
    out, m, l = at.mhsa_fwd(q, q, q, bias, seeds, 2, 0.125, 0.1)
    at.mhsa_bwd(q, q, q, bias, seeds, m, l, out, 2, 0.125, 0.1)
    assert at.mhsa_fwd.tc_launches == at.mhsa_bwd.tc_launches == 0
