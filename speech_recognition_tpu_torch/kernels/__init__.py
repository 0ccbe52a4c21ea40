"""Build and bind the hand-written CUDA kernels under ``csrc/``.

The kernels have a plain C interface, so they compile with ``nvcc`` alone
(no PyTorch headers: seconds, not minutes) into one shared library that is
loaded with ``ctypes``.  Each ``.cu`` source compiles in its own ``nvcc``
process, all started together, and one more call links the objects.  The build happens at first use, from the package's
own sources, into ``build/torch_kernels/`` beside the package; the library's
file name carries a hash of the sources, so an edited source is rebuilt.
Target: ``sm_90a`` (H100).  Nothing here runs at import time: the CPU tests
import every module of the port.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` after its launches; the Python wrappers
call it through ``launch``, which makes the operands' device the current one
for the call and raises when that is not 0.
"""

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # ptxas report of the last build (registers, shared memory, spills)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype_bf16, bias_f32, hid, W, b, R, H, V, k, rounding, wgs, stage_k, tiles_per_block,
    # part_val, part_idx, part_max, part_sum, vals, idx, lse, run_flag, stream
    "vocab_topk": [_I, _I, _P, _P, _P] + [_I] * 8 + [_P] * 9,
    # pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs,
    # h, c, prev_tok, ended, logp_sum, tokens, step, L, hidden,
    # part_val, part_idx, part_max, part_sum, B, S, H, He, Dv, V, eos_id, pad_id, stream
    "las_greedy_step": [_P] * 8 + [_I] + [_P] * 3 + [_P] * 6 + [_I, _I] + [_P] * 5 + [_I] * 8 + [_P],
    # emb, token_mask, pk, value, attn_bias, qw, qb, n_cells, ks, rs, bs, cms, zs, cps,
    # out_mask, h0, c0, hidden, h_start, c_in0, h_last, c_last, N, B, S, H, He, Dv, stream (float32)
    "las_decoder_fwd": [_P] * 7 + [_I] + [_P] * 6 + [_P] * 8 + [_I] * 6 + [_P],
    # emb_rows, rows, token_mask, pk, value, attn_bias, qw, qb, n_cells, ws, bs, out_masks, zs, cps, ctx_mask,
    # ctx_ld, h, c, hq, q, scores, x0, xs, hidden, h_state, c_state, N, B, S, H, He, Dv, Hu, q_wgs, q_panels, c_wgs,
    # c_panels, stream
    "las_decoder_fwd_split": [_P] * 8 + [_I] + [_P] * 6 + [_I] + [_P] * 10 + [_I] * 11 + [_P],
    # dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw_t, n_cells,
    # kts, rts, cms, zs, cps, dzs, out_mask, demb, dctx, dscores, dq, dh0, dc0, N, B, S, H, He, Dv, stream (float32)
    "las_decoder_bwd": [_P] * 9 + [_I] + [_P] * 6 + [_P] * 7 + [_I] * 6 + [_P],
    # dhidden, dh_last, dc_last, token_mask, probs, c_in0, pk, value, qw_t, n_cells, ws, cms, zs, cps, dzs,
    # out_mask, demb, dctx, dscores, dq, dh0, dc0, dh, dc, dctx_f, dprobs, N, B, S, H, He, Dv, q_wgs, q_panels,
    # c0_wgs, c0_panels, c_wgs, c_panels, stream
    "las_decoder_bwd_split": [_P] * 9 + [_I] + [_P] * 5 + [_P] * 7 + [_P] * 4 + [_I] * 12 + [_P],
    # dtype_bf16, hid, W, b, y, R, H, V, wgs, stage_k, tiles_per_block,
    # part_val, part_idx, part_max, part_sum, lse, lab, pred, stream
    "ce_vocab_fwd": [_I] + [_P] * 4 + [_I] * 6 + [_P] * 8,
    # dtype_bf16, hid, W, b, ids, R, T, K, H, V, wgs, stage_k, tiles_per_block, id_list,
    # part_val, part_idx, part_max, part_sum, lse, vals, stream
    "ctc_emissions_fwd": [_I] + [_P] * 4 + [_I] * 8 + [_P] * 8,
    # dtype_bf16, hid, W, b, ids, lse, dvals, R, T, K, H, V, n_split, row_wgs, tile, chunk_panels,
    # rows_per_split, merged, ids_first, dlse, lab, dW_part, db_part, dhid, dW, db, stream
    "ctc_emissions_bwd": [_I] + [_P] * 6 + [_I] * 10 + [_P] * 10,
    # dtype_bf16, route, passes, stages, q, k, v, bias, seeds, B, T, H, d, scale, p_drop, inv_keep, out, m, l, stream
    "mhsa_fwd": [_I] * 4 + [_P] * 5 + [_I] * 4 + [_F] * 3 + [_P] * 4,
    # dtype_bf16, route, stages, q, k, v, bias, seeds, m, l, dout, B, T, H, d, scale, p_drop, inv_keep,
    # rowterm, dq, dk, dv, stream
    "mhsa_bwd": [_I] * 3 + [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P] * 5,
    # x, l, n, out_fast, out_exact, stream
    "mhsa_divide_check": [_P, _P, _I, _P, _P, _P],
    # dtype_bf16, enc, pred, W, b, ids, p (NULL: every node), B, T, U1, S, J, V, blank, wgs, stage_k,
    # tiles_per_block, lpb, lpe, lse, stream
    "transducer_joint_fwd": [_I] + [_P] * 6 + [_I] * 10 + [_P] * 4,
    # dtype_bf16, enc, pred, W, b, ids, p, B, T, U1, S, J, V, blank, lse, dlpb, dlpe, n_split, row_wgs,
    # tile, chunk_panels, rows_per_split, hbuf, dpre, dW_part, db_part, denc, dpred, dW, db, stream
    "transducer_joint_bwd": [_I] + [_P] * 6 + [_I] * 7 + [_P] * 3 + [_I] * 5 + [_P] * 9,
    # dtype_bf16, is_gru, x, mask, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, stream
    "rnn_sequence": [_I, _I] + [_P] * 9 + [_I] * 4 + [_P],
    # is_gru, x, mask, rk_il, rb, c0, hbuf, done, out, h_last, c_last, T, D, B, H, ctas, slice_rows, stream
    "rnn_sequence_persistent": [_I] + [_P] * 10 + [_I] * 6 + [_P],
    # is_gru, x, mask, mask_pitch, rk, rb, h0, c0, out, h_last, c_last, T, D, B, H, units, cluster, stages, stream
    "rnn_sequence_cluster_tc": [_I, _P, _P, _I] + [_P] * 7 + [_I] * 7 + [_P],
    # pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ks, rs, bs, h, c, tokens, logp, ended,
    # eoslen, live, hidden, part_val, part_idx, part_max, part_sum, B, K, S, H, He, Dv, V, L, step0, n_steps,
    # eos_id, pad_id, alpha, beta_den, beams_per_block, stream
    "las_beam_search": [_P] * 8 + [_I] + [_P] * 3 + [_P] * 12 + [_I] * 12 + [_F] * 2 + [_I] + [_P],
    # pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ws, bs, h, c, hq, q, scores, x0, xs, parity, prev_tok,
    # ended, logp_sum, tokens, step, L, hidden, part_val, part_idx, part_max, part_sum, B, S, H, He, Dv, Hu, V, eos_id,
    # pad_id, q_wgs, q_panels, c_wgs, c_panels, wgs, stage_k, tiles_per_block, stream
    "las_greedy_step_split": [_P] * 8 + [_I] + [_P] * 9 + [_I] + [_P] * 4 + [_I] * 2 + [_P] * 5 + [_I] * 16 + [_P],
    # pk, value, attn_bias, qw, qb, emb, vw, vb, n_cells, ws, bs, h, c, hq, q, scores, x0, xs, tokens, logp, ended,
    # eoslen,
    # live, hidden, part_val, part_idx, part_max, part_sum, B, K, S, H, He, Dv, Hu, V, L, step0, n_steps, eos_id,
    # pad_id, alpha, beta_den, q_wgs, q_panels, c_wgs, c_panels, wgs, stage_k, tiles_per_block, stream
    "las_beam_search_split": [_P] * 8 + [_I] + [_P] * 19 + [_I] * 13 + [_F] * 2 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library (if not already built) and return its path."""
    global build_log
    digest = hashlib.sha1()
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libsrt_kernels_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = f"{tag}.{os.path.basename(src)}.o"
        cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src]
        jobs.append((src, obj, subprocess.Popen(cmd, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)))
    logs, failed = [], []
    for src, obj, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err[-8000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{tag}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    build_log = "".join(logs)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    return library().kernels_error_string(code).decode()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def device_scope(device) -> contextlib.AbstractContextManager:
    """A block with ``device`` the current CUDA device (for a CPU device, a block
    that changes nothing).  Work placed on a card other than the current one runs
    in such a block: a kernel's entry point, a CUDA graph's capture and replay
    and ``torch.cuda.Stream()`` all take the current device, not their operands'."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and ``device``'s current
    stream, ``device`` made the current CUDA device for the call; raise if it
    returns an error.  Every kernel wrapper launches through here: the entry
    points set their kernels' shared-memory attributes, read the device's
    limits (``cudaGetDevice``) and launch on the current device, so an operand
    on another card than the current one would otherwise go to the wrong one."""
    lib = library()
    with device_scope(device):
        err = getattr(lib, name)(*args, stream(device))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {error_string(err)}")


_DTENSOR = None  # torch.distributed.tensor.DTensor, imported on the first check


def is_dtensor(t) -> bool:
    """True for a DTensor: a parameter that FSDP2 holds sharded."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(t, _DTENSOR)


def _dtensors(items):
    for t in items:
        if isinstance(t, (list, tuple)):
            yield from _dtensors(t)
        elif is_dtensor(t):
            yield t


def plain_route(*operands) -> bool:
    """True when a wrapper takes its kernel's plain version: its first operand
    lies on the CPU.  A DTensor operand (a parameter left sharded by FSDP)
    raises, on either route and before any launch: every kernel, and its plain
    version, reads the whole plain tensor, gathered before the call."""
    if any(True for _ in _dtensors(operands)):
        raise TypeError("a kernel operand is a DTensor: gather it into a plain tensor before the call")
    return operands[0].device.type == "cpu"


def check_operands(dtypes, device=None, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one of ``dtypes``
    (and on ``device``, when given)."""
    allowed = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    for name, t in tensors.items():
        if t.device.type != "cuda" or (device is not None and t.device != device):
            raise ValueError(f"{name}: expected a CUDA tensor on {device or 'cuda'}, got {t.device}")
        if t.dtype not in allowed:
            raise ValueError(f"{name}: dtype {t.dtype} not in {allowed}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
