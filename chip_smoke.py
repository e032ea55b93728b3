#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--seed N] [--requests N] [--train-steps N]

Phases (any failure raises and the script exits non-zero):

  1. setup — print the card and its power limit, turn TF32 off, build the
     CUDA sources from ``tpu_pipelines_torch/csrc`` (one nvcc each, all
     started together) and print the build times;
  2. kernels — hold each kernel against its plain PyTorch version on the
     card at its main path's shapes and at edge cases (ragged length,
     causal, an all-masked batch row, fp16/f32, strided inputs), and time
     it beside its plain version, the one-call PyTorch yardstick and its
     bound (the forward at the serving shape, the backward kernels at the
     training shape); hold the attention's gradients against autograd
     through dense attention in f32;
  3. serving — export a BERT-base payload (full width, random weights from
     ``--seed``) with flash attention, serve it with ``ModelServer`` on the
     card with micro-batching, send concurrent REST ``:predict`` requests,
     and check every reply against the same weights served with dense
     attention (and that a wrong key mask would fail that check), and that
     every device batch launched the flash kernel once per layer;
  4. training — fine-tune BERT-base (full width, bf16, dropout 0.1, random
     init from ``--seed``) through ``train_loop`` at batch 256 x 128 with
     ragged lengths: every loss finite, each of the three attention kernels
     launched once per layer and step, the first step's q/k/v projection
     gradients, the loop's AdamW first moment of those weights after its
     last step, and every step's loss within tolerance of the same run
     with dense attention (and two wrong-mask controls outside each);
     report examples/s/chip, MFU, peak memory and a profiled step.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2 before
printing any result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.examples import bert_module
from tpu_pipelines_torch.models.bert import (
    DEFAULT_HPARAMS,
    build_bert_model,
    init_bert_weights,
)
from tpu_pipelines_torch.ops import _build
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.ring_attention import dense_attention
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model
from tpu_pipelines_torch.trainer.train_loop import (
    _peak_flops_per_chip,
    step_generator,
)

REPO = os.path.dirname(os.path.abspath(__file__))
BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples", "bert_module.py")

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type (bf16/fp16 on the tensor cores, f32 on the
# FMA units).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12,
}
# Kernel vs plain version: both compute in f32 and differ only in the order
# of f32 sums, so each output element may land one rounding step (ulp) of
# the output dtype away: |out - ref| <= atol + rtol * |ref| with rtol one
# ulp relative (bf16 2^-7, fp16 2^-10) and a small atol for outputs near 0.
# The LSE is f32 in both.
OUT_TOL = {  # dtype: (rtol, atol)
    torch.bfloat16: (2.0 ** -7, 1e-5),
    torch.float16: (2.0 ** -10, 1e-6),
    torch.float32: (1e-6, 1e-6),
}
LSE_TOL = (1e-6, 1e-5)
# Served logits, flash vs dense attention, bf16 compute: dense rounds the
# softmax probabilities to bf16 before P.V, flash keeps them in f32, so the
# two drift apart by bf16 rounding through 12 layers.  The serving phase
# also runs controls (the flash payload fed a wrong key mask) and fails
# unless each of them lands above this tolerance.  On an H100 80GB HBM3
# (700 W) at --seed 0 the sound gap was 8.4e-3 and the controls 1.9e-1
# and 2.0e-1: the tolerance sits near their geometric mean.
LOGIT_TOL = 4e-2
N_LAYERS = DEFAULT_HPARAMS["n_layers"]
SEQ_LEN = 128
# Backward kernels vs their plain versions: the same f32 math from the same
# q, k, v, dO, lse and Dvec, differing only in the order of f32 sums.  Each
# gradient element may land one rounding step of the output dtype away
# (OUT_TOL's rtol), plus an absolute term for elements that cancel: two
# orders of a sum of L terms differ by at most about L * 2^-24 of the sum of
# |terms|, taken as L * 2^-24 * max|ref| of the tensor.
F32_EPS = 2.0 ** -24
# The attention's gradients (forward and backward kernels through the
# autograd Function) vs autograd through dense attention, f32: two formulas
# (softmax vs the saved LSE), f32 sums over at most 100 keys.
DENSE_GRAD_TOL = (1e-5, 2e-5)  # (rtol, atol)
TRAIN_BATCH = 256
TRAIN_LR = 2e-5
TRAIN_WINDOW = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ kernels

# name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs
KERNEL_CASES = [
    ("serving", 32, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
]


def tol_ratio(got, want, rtol_atol) -> float:
    """max |got - want| / (atol + rtol * |want|): at most 1 within tolerance."""
    rtol, atol = rtol_atol
    got, want = got.double(), want.double()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided, n=3):
    """``n`` random [b, l, h, d] tensors (q, k, v and, for the backward,
    dO) and the key mask; strided: slices of one packed tensor."""
    dev = "cuda"
    if strided:  # slices of one packed [b, l, n, h, d] tensor
        packed = torch.randn(b, l, n, h, d, generator=gen).to(dev, dtype)
        tensors = [packed[:, :, i] for i in range(n)]
    else:
        tensors = [torch.randn(b, l, h, d, generator=gen).to(dev, dtype)
                   for _ in range(n)]
    if mask_kind == "none":
        return (*tensors, None)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if mask_kind == "empty_row":
        mask[1] = 0
    return (*tensors, mask.to(dev))


def kernel_phase(gen):
    """Every case within tolerance; returns the flash_fwd record (without
    launches) measured at the serving shape."""
    max_out_err = max_lse_err = 0.0
    record = None
    for name, b, l, h, d, dtype, causal, mask_kind, strided in KERNEL_CASES:
        q, k, v, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, kv_mask=mask
        )
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_ratio = tol_ratio(out, ref_out, OUT_TOL[dtype])
        lse_ratio = tol_ratio(lse, ref_lse, LSE_TOL)
        ok = (
            torch.isfinite(out.float()).all().item()
            and out_ratio <= 1.0 and lse_ratio <= 1.0
        )
        if mask_kind == "empty_row":
            ok = ok and out[1].abs().max().item() == 0.0
            ok = ok and bool((lse.view(b, h, l)[1] == fa.NEG_INF).all().item())
        print(f"kernel flash_fwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided} "
              f"max|out-ref|={out_err:.3e} ({out_ratio:.3f} of tol "
              f"{OUT_TOL[dtype][1]:g} + {OUT_TOL[dtype][0]:g}*|ref|) "
              f"max|lse-ref|={lse_err:.3e} ({lse_ratio:.3f} of tol "
              f"{LSE_TOL[1]:g} + {LSE_TOL[0]:g}*|ref|)", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd {name}: kernel disagrees with "
                                 "its plain version")
        max_out_err = max(max_out_err, out_err)
        max_lse_err = max(max_lse_err, lse_err)
        if name == "serving":
            record = serving_shape_timing(q, k, v, mask, causal)
    record["max_abs_err"] = max_out_err
    record["lse_max_abs_err"] = max_lse_err
    return record


def serving_shape_timing(q, k, v, mask, causal):
    b, l, h, d = q.shape
    item = q.element_size()
    ms = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, kv_mask=mask))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask), iters=50)
    # Yardstick only: one PyTorch call computing the same function (no row
    # of this case is fully masked, where SDPA and the kernel would differ).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = (mask > 0)[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask))
    # Least time for the same work, counted over what this run's mask
    # needs: q read and out written in full, k and v read only at allowed
    # keys, the [B, L] int32 mask read and the [B*H, L] f32 LSE written
    # once; operations over the allowed (query, key) pairs.
    allowed_keys = int((mask > 0).sum().item())       # over batch rows
    bytes_moved = (2 * q.numel() * item + 2 * allowed_keys * h * d * item
                   + b * l * 4 + b * h * l * 4)
    ops = 4 * h * d * l * allowed_keys
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    print(f"kernel flash_fwd serving shape: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms); bound {max(t_bytes, t_ops)*1e3:.4f} "
          f"ms ({bytes_moved} bytes, {ops} ops)", flush=True)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_pipelines_torch/csrc/flash_attention.cu",
        "replaces": "tpu_pipelines/ops/flash_attention.py:59",
        "tpu_kernel": "_fwd_kernel",
        "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


# (name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs)
# for the backward kernels; "training" is the fine-tune phase's shape.
BWD_CASES = [
    ("training", TRAIN_BATCH, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
]


def bwd_kernel_phase(gen):
    """Every backward case within tolerance, the gradients against dense
    attention; returns the flash_bwd_dq and flash_bwd_dkv records (without
    launches) measured at the training shape."""
    max_err = {"dq": 0.0, "dkv": 0.0}
    records = None
    for name, b, l, h, d, dtype, causal, mask_kind, strided in BWD_CASES:
        q, k, v, dout, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind,
                                            strided, n=4)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        dvec = fa._dvec(out, dout)
        args = (q, k, v, dout, lse, dvec)
        dq = fa.flash_bwd_dq(*args, causal=causal, kv_mask=mask)
        dk, dv = fa.flash_bwd_dkv(*args, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        ref_dq = fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*args, causal=causal,
                                                    kv_mask=mask)
        parts = []
        ok = True
        for grad, got, want, kernel in (("dq", dq, ref_dq, "dq"),
                                        ("dk", dk, ref_dk, "dkv"),
                                        ("dv", dv, ref_dv, "dkv")):
            scale = want.double().abs().max().item()
            tol = (OUT_TOL[dtype][0], l * F32_EPS * scale)
            err = (got.double() - want.double()).abs().max().item()
            ratio = tol_ratio(got, want, tol)
            ok = ok and torch.isfinite(got.float()).all().item() and ratio <= 1.0
            if mask_kind == "empty_row":  # the all-masked batch row
                ok = ok and got[1].abs().max().item() == 0.0
            max_err[kernel] = max(max_err[kernel], err)
            parts.append(f"{grad} max|err|={err:.3e} ({ratio:.3f} of tol "
                         f"{tol[1]:.2e} + {tol[0]:g}*|ref|)")
        print(f"kernel flash_bwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided} "
              + " ".join(parts), flush=True)
        if not ok:
            raise AssertionError(f"flash_bwd {name}: kernels disagree with "
                                 "their plain versions")
        if name == "training":
            records = training_shape_timing(q, k, v, dout, out, lse, dvec, mask)
    for kernel, record in zip(("dq", "dkv"), records):
        record["max_abs_err"] = max_err[kernel]
    dense_gradient_check(gen)
    return records


def dense_gradient_check(gen):
    """Gradients through the autograd Function (forward and backward
    kernels) against autograd through dense attention, f32 (an independent
    oracle: softmax in place of the saved LSE)."""
    for causal in (False, True):
        # Ragged lengths >= 1: no empty row, where dense attention differs.
        q, k, v, dout, mask = kernel_inputs(gen, 2, 100, 3, 32, torch.float32,
                                            "ragged", False, n=4)
        grads = []
        for attend in (fa.flash_attention, dense_attention):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            attend(*leaves, causal=causal, kv_mask=mask).backward(dout)
            grads.append([t.grad for t in leaves])
        ratio = max(tol_ratio(a, b, DENSE_GRAD_TOL) for a, b in zip(*grads))
        err = max((a - b).abs().max().item() for a, b in zip(*grads))
        print(f"kernel flash_bwd gradients vs autograd through dense attention "
              f"(f32, causal={causal}): max|err|={err:.3e} ({ratio:.3f} of tol "
              f"{DENSE_GRAD_TOL[1]:g} + {DENSE_GRAD_TOL[0]:g}*|ref|)", flush=True)
        if ratio > 1.0:
            raise AssertionError("flash attention gradients disagree with "
                                 "dense attention")


def training_shape_timing(q, k, v, dout, out, lse, dvec, mask):
    b, l, h, d = q.shape
    item = q.element_size()
    args = (q, k, v, dout, lse, dvec)
    ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq(*args, kv_mask=mask), iters=50),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv(*args, kv_mask=mask), iters=50),
    }
    plain_ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq_reference(*args, kv_mask=mask),
                      iters=10, warmup=2),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(*args, kv_mask=mask),
                       iters=10, warmup=2),
    }
    dvec_ms = time_ms(lambda: fa._dvec(out, dout), iters=50)
    total_ms = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, dout, kv_mask=mask), iters=50)
    # Yardstick only: SDPA's backward (dq, dk and dv in one call), timed
    # alone at the same shape and mask (no row of this case is empty).
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=(mask > 0)[:, None, None, :])
    dout_t = dout.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), iters=50)
    # Least time for the same work, counted over what this run's mask
    # needs: q, dO, lse and Dvec rows of batch rows with any allowed key
    # (an empty row's gradients are zeros to write), k and v only at allowed
    # keys, the [B, L] int32 mask; each gradient written once.  Operations
    # over the allowed (query, key) pairs: s, dP and dQ (dq kernel) or s,
    # dP, dV and dK (dkv kernel), 2*D each.
    allowed_keys = (mask > 0).sum(dim=1)                     # per batch row
    live_rows = int((allowed_keys > 0).sum().item())
    pairs = h * l * int(allowed_keys.sum().item())
    full = b * l * h * d * item
    rows_in = 2 * live_rows * l * h * d * item + 2 * live_rows * h * l * 4
    kv_in = 2 * int(allowed_keys.sum().item()) * h * d * item
    mask_in = b * l * 4
    work = {
        "dq": (rows_in + kv_in + mask_in + full, 6 * d * pairs),
        "dkv": (rows_in + kv_in + mask_in + 2 * full, 8 * d * pairs),
    }
    replaces = {"dq": ("_dq_kernel", "tpu_pipelines/ops/flash_attention.py:154"),
                "dkv": ("_dkv_kernel", "tpu_pipelines/ops/flash_attention.py:193")}
    records = []
    for kernel in ("dq", "dkv"):
        bytes_moved, ops = work[kernel]
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS_PER_S[q.dtype]
        print(f"kernel flash_bwd_{kernel} training shape: {ms[kernel]:.4f} ms "
              f"(plain {plain_ms[kernel]:.4f} ms); bound "
              f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({bytes_moved} bytes, {ops} "
              f"ops)", flush=True)
        records.append({
            "name": f"flash_bwd_{kernel}",
            "route": "cuda",
            "source": "tpu_pipelines_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces[kernel][1],
            "tpu_kernel": replaces[kernel][0],
            "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
            "ms": ms[kernel],
            "plain_ms": plain_ms[kernel],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (dq, dk, dv together)",
        })
    print(f"kernel flash backward training shape: Dvec {dvec_ms:.4f} ms + dq "
          f"{ms['dq']:.4f} ms + dkv {ms['dkv']:.4f} ms; whole backward "
          f"{total_ms:.4f} ms; sdpa backward {library_ms:.4f} ms", flush=True)
    return records


# ------------------------------------------------------------------ serving

def make_requests(rng, n_requests, vocab):
    requests = []
    for _ in range(n_requests):
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            n = int(rng.integers(8, SEQ_LEN + 1))
            ids = np.zeros(SEQ_LEN, np.int64)
            ids[:n] = rng.integers(1, vocab, size=n)
            rows.append({"input_ids": ids.tolist(),
                         "attention_mask": (ids > 0).astype(np.int64).tolist()})
        requests.append({"instances": rows})
    return requests


# Clients run in their own interpreters (no torch), so that their JSON and
# HTTP work does not compete with the server for its interpreter lock.
CLIENT = r"""
import json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
job = json.load(sys.stdin)

def post(item):
    i, payload = item
    req = urllib.request.Request(
        job["url"], data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            code, reply = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        code, reply = e.code, None
    return [i, code, reply, time.perf_counter() - t0]

t0 = time.perf_counter()
with ThreadPoolExecutor(job["threads"]) as pool:
    results = list(pool.map(post, job["requests"]))
json.dump({"t0": t0, "t1": time.perf_counter(), "results": results}, sys.stdout)
"""
N_CLIENT_PROCS = 4
CLIENT_THREADS = 16


def run_clients(url, requests):
    """POST every request from N_CLIENT_PROCS processes of CLIENT_THREADS
    threads each; returns ([(code, reply, seconds)] in request order, wall
    seconds from the first request sent to the last reply)."""
    procs = []
    try:
        for c in range(N_CLIENT_PROCS):
            proc = subprocess.Popen(
                [sys.executable, "-c", CLIENT], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
            procs.append(proc)
            job = {"url": url, "threads": CLIENT_THREADS, "requests": [
                [i, requests[i]]
                for i in range(c, len(requests), N_CLIENT_PROCS)]}
            proc.stdin.write(json.dumps(job))
            proc.stdin.close()
        outs = []
        for proc in procs:
            outs.append(json.loads(proc.stdout.read()))
            if proc.wait(timeout=600) != 0:
                raise RuntimeError(f"client exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = [None] * len(requests)
    for out in outs:
        for i, code, reply, seconds in out["results"]:
            results[i] = (code, reply, seconds)
    wall_s = max(o["t1"] for o in outs) - min(o["t0"] for o in outs)
    return results, wall_s


def step_breakdown(loaded, batch, iters=20):
    """Host wall time of one served forward step (predict on a padded
    batch, synchronized by its host copy) and, from torch.profiler, the
    device time its kernels take: (wall_ms, busy_ms, flash_ms, kernels)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        loaded.predict(batch)
    t0 = time.perf_counter()
    for _ in range(iters):
        loaded.predict(batch)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            loaded.predict(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    flash_us = sum(e.time_range.elapsed_us() for e in kernels
                   if "flash_fwd_kernel" in e.name)
    return wall_ms, busy_us / 5e3, flash_us / 5e3, len(kernels) / 5


def serving_phase(seed, n_requests, card, workdir):
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash"}
    model = build_bert_model(hp)
    init_bert_weights(model, torch.Generator().manual_seed(seed))
    state = model.state_dict()
    base = os.path.join(workdir, "bert")
    export_model(serving_model_dir=os.path.join(base, "1"), params=state,
                 module_file=BERT_MODULE, hyperparameters=hp)
    dense_dir = os.path.join(workdir, "bert_dense", "1")
    export_model(serving_model_dir=dense_dir, params=state,
                 module_file=BERT_MODULE,
                 hyperparameters={**hp, "attn_impl": "dense"})
    del model, state

    rng = np.random.default_rng(seed)
    requests = make_requests(rng, n_requests, hp["vocab_size"])
    torch.cuda.reset_peak_memory_stats()
    server = ModelServer("bert", base, batching=True, max_batch_size=32,
                         device="cuda")
    try:
        port = server.start(port=0)
        url = f"http://127.0.0.1:{port}/v1/models/bert:predict"
        warm, _ = run_clients(url, requests[:1])  # first cuBLAS calls
        if warm[0][0] != 200:
            raise AssertionError(f"warm-up request answered {warm[0][0]}")
        batches = server.metrics.get("serving_batches_total")
        batches_before = batches.get()
        fa.launches = 0
        results, wall_s = run_clients(url, requests)
        launches = fa.launches
        n_batches = int(batches.get() - batches_before)
        peak_bytes = torch.cuda.max_memory_allocated()
        scrape = server.metrics.to_prometheus()
    finally:
        server.stop()

    codes = [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"non-200 replies: {sorted(set(codes))}")
    for payload, (_, reply, _) in zip(requests, results):
        got = np.asarray(reply["predictions"], np.float32)
        if got.shape != (len(payload["instances"]), hp["num_classes"]):
            raise AssertionError(f"reply shape {got.shape}")
        if not np.isfinite(got).all():
            raise AssertionError("non-finite logits")
    served = np.concatenate(
        [np.asarray(reply["predictions"], np.float32)
         for _, reply, _ in results])
    rows = served.shape[0]
    instances = [r for p in requests for r in p["instances"]]
    ids = np.asarray([r["input_ids"] for r in instances])
    mask = np.asarray([r["attention_mask"] for r in instances])
    dense = load_exported_model(dense_dir, device="cuda")
    flash = load_exported_model(os.path.join(base, "1"), device="cuda")

    def predict(loaded, mask_rows):
        return np.concatenate([
            loaded.predict({"input_ids": ids[i:i + 32],
                            "attention_mask": mask_rows[i:i + 32]})
            for i in range(0, rows, 32)])

    want = predict(dense, mask)
    max_err = float(np.abs(served - want).max())
    # Controls: the flash payload fed a wrong key mask — none (every pad
    # key attended) and each row's neighbour's — must miss the dense
    # logits by more than LOGIT_TOL, or the check could not catch a kernel
    # that ignored the mask or mixed up batch rows.
    controls = {
        "mask dropped": np.ones_like(mask),
        "mask of the next row": np.roll(mask, 1, axis=0),
    }
    control_err = {name: float(np.abs(predict(flash, m) - want).max())
                   for name, m in controls.items()}
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    # Server-side mean (handler entry to reply) over warm-up + run, from the
    # server's own latency histogram.
    def scraped(name):
        return float(re.search(
            rf'^{name}{{endpoint="predict"}} (\S+)$', scrape, re.M)[1])
    server_ms = (scraped("serving_request_latency_seconds_sum")
                 / scraped("serving_request_latency_seconds_count") * 1e3)
    print(f"serving [{card}]: BERT-base (d_model {hp['d_model']}, "
          f"{hp['n_layers']} layers, {hp['n_heads']} heads, vocab "
          f"{hp['vocab_size']}) bf16, flash attention, L={SEQ_LEN}, "
          f"{N_CLIENT_PROCS * CLIENT_THREADS} concurrent clients: "
          f"{len(requests)} requests ({rows} rows) in {n_batches} device "
          f"batches; p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms (server-side mean "
          f"{server_ms:.2f} ms); {rows / wall_s:.1f} examples/s; "
          f"peak device memory {peak_bytes} bytes", flush=True)
    print(f"serving: max |flash - dense| logit = {max_err:.3e} (tol {LOGIT_TOL:g}); "
          f"flash_fwd launches {launches} = {N_LAYERS} x {n_batches} batches "
          f"expected", flush=True)
    for name, err in control_err.items():
        print(f"serving control, {name}: max |flash - dense| logit = "
              f"{err:.3e} (must exceed tol {LOGIT_TOL:g})", flush=True)
    if max_err > LOGIT_TOL:
        raise AssertionError("flash-served logits disagree with dense")
    if min(control_err.values()) <= LOGIT_TOL:
        raise AssertionError(
            "a wrong key mask stays within LOGIT_TOL: the served check "
            "cannot tell a faulty kernel")
    if n_batches < 1 or launches != N_LAYERS * n_batches:
        raise AssertionError(
            f"flash_fwd launched {launches} times for {n_batches} batches")

    batch32 = {"input_ids": ids[:32], "attention_mask": mask[:32]}
    for name, loaded in (("flash", flash), ("dense", dense)):
        wall_ms, busy_ms, flash_ms, n_kernels = step_breakdown(loaded, batch32)
        print(f"serving step [{card}] {name} attention, batch 32 x {SEQ_LEN}: "
              f"host wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"(idle share {1 - busy_ms / wall_ms:.3f}), flash_fwd "
              f"{flash_ms:.3f} ms, {n_kernels:.0f} kernels per step", flush=True)
    return launches


# ----------------------------------------------------------------- training

# Flash vs dense attention in the bf16 fine-tune, from the same init,
# batches and dropout generators: dense rounds the softmax probabilities to
# bf16 before P.V, flash keeps them in f32.  Three checks, each against two
# controls (flash fed no key mask, or each row's neighbour's) that must land
# above its tolerance; each tolerance sits near the geometric mean of the
# sound gap and the smaller control, measured on an H100 80GB HBM3 (700 W)
# at --seed 0:
#   - GRAD_TOL bounds the relative L2 error of the first step's q/k/v
#     projection-weight gradients, which reach the weights only through
#     dq/dk/dv (sound 2.9e-2, controls 8.7e-1 and 1.04);
#   - MOMENT_TOL bounds the relative L2 error of AdamW's first moment of
#     every q/k/v projection weight after the whole train_loop run (the
#     loop's own optimizer state, an EMA of the gradients of all its
#     steps), the controls being train_loop runs fed the wrong masks
#     (sound 3.4e-2, controls 1.12 and 1.0);
#   - LOSS_TOL bounds the relative error of every step's loss in those
#     runs (sound 1.7e-3, controls 1.6e-1 and 3.9e-2).  Step 1 alone
#     cannot tell: at random init the loss stays near ln 2 whatever the
#     mask, and the runs part only as the classifier learns.
GRAD_TOL = 1.5e-1
MOMENT_TOL = 1.8e-1
LOSS_TOL = 1e-2
DEVICE = "cuda"


def training_batches(seed, vocab, n):
    """``n`` batches of TRAIN_BATCH x SEQ_LEN with ragged real lengths
    (8..SEQ_LEN), pad id 0 behind them, and bench.py's label rule."""
    rng = np.random.default_rng(seed + 1)
    batches = []
    for _ in range(n):
        lengths = rng.integers(8, SEQ_LEN + 1, size=TRAIN_BATCH)
        mask = np.arange(SEQ_LEN)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, vocab, size=(TRAIN_BATCH, SEQ_LEN)), 0)
        batches.append({
            "input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "label": (ids[:, 0] % 2).astype(np.int32),
        })
    return batches


QKV_WEIGHT = re.compile(r"\.attn\.(query|key|value)\.weight$")


def run_training(hp, seed, batches):
    """train_loop over ``batches``; returns (model, result, per-step losses,
    {q/k/v projection weight: AdamW's first moment after the run})."""
    losses, optimizers = [], []

    def optimizer(params):
        optimizers.append(bert_module.adamw(TRAIN_LR)(params))
        return optimizers[-1]

    model, result = train_loop(
        loss_fn=bert_module.loss_fn,
        init_params_fn=functools.partial(bert_module.init_params_fn,
                                         hyperparameters=hp),
        optimizer=optimizer,
        train_iter=iter(batches),
        config=TrainLoopConfig(
            train_steps=len(batches), batch_size=TRAIN_BATCH, log_every=1,
            window_steps=TRAIN_WINDOW, anchor_every=TRAIN_WINDOW, seed=seed,
        ),
        metrics_cb=lambda step, m: losses.append(m["loss"]),
        device=DEVICE,
    )
    moments = {name: optimizers[0].state[p]["exp_avg"]
               for name, p in model.named_parameters()
               if QKV_WEIGHT.search(name)}
    return model, result, losses, moments


def first_step_grads(hp, seed, batch):
    """Step 1's loss and q/k/v projection-weight gradients (the train
    loop's init and step-0 generator) for the model ``hp`` on ``batch``."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    loss, _ = bert_module.loss_fn(
        model, {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()},
        step_generator(seed, 0, DEVICE))
    loss.backward()
    return loss.item(), {
        name: p.grad for name, p in model.named_parameters()
        if QKV_WEIGHT.search(name)}


def rel_l2(got, want):
    return {name: (got[name] - w).norm().item() / w.norm().item()
            for name, w in want.items()}


def train_step_breakdown(hp, seed, batch, iters=3):
    """Host wall of one fine-tune step (forward, backward, AdamW; ends in a
    synchronize) and, from torch.profiler, its device time: (wall_ms,
    profiled wall_ms, busy_ms, {kernel: ms}, kernels per step)."""
    from torch.profiler import ProfilerActivity, profile

    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    opt = bert_module.adamw(TRAIN_LR)(model.parameters())
    dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}

    def step(i):
        loss, _ = bert_module.loss_fn(model, dev_batch,
                                      step_generator(seed, i, DEVICE))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()

    for i in range(2):
        step(i)
    t0 = time.perf_counter()
    for i in range(iters):
        step(i)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(i)
        profiled_ms = (time.perf_counter() - t0) / iters * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # Device busy = the union of kernel intervals (overlaps counted once),
    # against the host wall of the same profiled steps: tracing lengthens
    # both, so the idle share compares like with like.
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / iters / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    by_kernel = {
        name: sum(us for kernel, us in by_name.items()
                  if f"{name}_kernel" in kernel) / iters / 1e3
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for kernel, us in top:
        print(f"training step top kernel: {us / iters / 1e3:.3f} ms/step "
              f"{kernel[:110]}", flush=True)
    return wall_ms, profiled_ms, busy_ms, by_kernel, len(kernels) / iters


def training_phase(seed, n_steps, card):
    """The slice's main path: BERT-base fine-tuning through train_loop with
    flash attention.  Returns the three kernels' launches in that run."""
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash", "max_len": SEQ_LEN,
          "num_classes": 2}
    batches = training_batches(seed, hp["vocab_size"], n_steps)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    model, result, losses, moments = run_training(hp, seed, batches)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    matmul_params = sum(
        p.numel() for name, p in model.named_parameters()
        if not re.search(r"(embed|pos_embed|type_embed)\.weight$", name))
    del model
    _, dense_result, dense_losses, want_moments = run_training(
        {**hp, "attn_impl": "dense"}, seed, batches)
    moment_err = rel_l2(moments, want_moments)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, dense_losses))

    want_loss, want = first_step_grads({**hp, "attn_impl": "dense"}, seed,
                                       batches[0])
    sound = rel_l2(first_step_grads(hp, seed, batches[0])[1], want)
    wrong_masks = {
        "mask dropped": np.ones_like,
        "mask of the next row": lambda m: np.roll(m, 1, axis=0),
    }
    control_err, control_loss, control_moment, control_run_loss = {}, {}, {}, {}
    for name, wrong in wrong_masks.items():
        fed = [{**b, "attention_mask": wrong(b["attention_mask"])}
               for b in batches]
        loss, grads = first_step_grads(hp, seed, fed[0])
        control_err[name] = max(rel_l2(grads, want).values())
        control_loss[name] = abs(loss - want_loss) / abs(want_loss)
        _, _, run_losses, got_moments = run_training(hp, seed, fed)
        control_moment[name] = max(rel_l2(got_moments, want_moments).values())
        control_run_loss[name] = max(
            abs(a - b) / abs(b) for a, b in zip(run_losses, dense_losses))

    # bench.py's analytic FLOPs: 6 N T for the weight matmuls plus the
    # attention score/value products (12 * layers * B * L^2 * d_model).
    flops_per_step = (6 * matmul_params * TRAIN_BATCH * SEQ_LEN
                      + 12 * hp["n_layers"] * TRAIN_BATCH * SEQ_LEN ** 2
                      * hp["d_model"])
    peak = _peak_flops_per_chip(DEVICE)
    eps = result.anchored_examples_per_sec_per_chip
    mfu = flops_per_step * eps / TRAIN_BATCH / peak if peak else None
    wall_ms, profiled_ms, busy_ms, by_kernel, n_kernels = train_step_breakdown(
        hp, seed, batches[0])

    print(f"training [{card}]: BERT-base (d_model {hp['d_model']}, "
          f"{hp['n_layers']} layers, {hp['n_heads']} heads, vocab "
          f"{hp['vocab_size']}) bf16, dropout {hp['dropout_rate']}, flash "
          f"attention, batch {TRAIN_BATCH} x {SEQ_LEN} ragged, AdamW "
          f"{TRAIN_LR:g}, {result.steps_completed} steps in windows of "
          f"{result.window_steps}", flush=True)
    print("training losses (flash): " + " ".join(f"{x:.5f}" for x in losses),
          flush=True)
    print("training losses (dense): " + " ".join(f"{x:.5f}" for x in dense_losses),
          flush=True)
    print(f"training: {result.anchored_examples_per_sec_per_chip} examples/s/chip "
          f"anchored over {result.anchor_windows} windows "
          f"({result.examples_per_sec_per_chip} whole-run; dense attention "
          f"{dense_result.anchored_examples_per_sec_per_chip} anchored); MFU "
          f"{'not measured' if mfu is None else f'{mfu:.4f}'} "
          f"({flops_per_step} analytic FLOP/step against {peak:g} FLOP/s); "
          f"peak device memory {peak_bytes} bytes", flush=True)
    print(f"training: launches {launches} = {N_LAYERS} x {len(losses)} steps "
          "expected for each", flush=True)
    for name, err in sound.items():
        print(f"training grad {name}: rel L2 |flash - dense| = {err:.3e}")
    print(f"training: max rel L2 |flash - dense| q/k/v weight grad = "
          f"{max(sound.values()):.3e} (tol {GRAD_TOL:g}); after "
          f"{len(losses)} steps, max rel L2 |flash - dense| AdamW first "
          f"moment of the q/k/v weights = {max(moment_err.values()):.3e} "
          f"(tol {MOMENT_TOL:g}); max rel |flash - dense| loss = "
          f"{loss_err:.3e} (tol {LOSS_TOL:g})", flush=True)
    for name, err in control_err.items():
        print(f"training control, {name}: max rel L2 |flash - dense| q/k/v "
              f"weight grad = {err:.3e} (must exceed tol {GRAD_TOL:g}); "
              f"AdamW first moment = {control_moment[name]:.3e} (must exceed "
              f"tol {MOMENT_TOL:g}); loss rel err max over the run "
              f"{control_run_loss[name]:.3e} (must exceed tol {LOSS_TOL:g}), "
              f"at step 1 {control_loss[name]:.3e}", flush=True)
    print(f"training step [{card}] flash attention, batch {TRAIN_BATCH} x "
          f"{SEQ_LEN}: host wall {wall_ms:.3f} ms ({profiled_ms:.3f} ms "
          f"traced), device busy {busy_ms:.3f} ms traced (idle share "
          f"{1 - busy_ms / profiled_ms:.3f}), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items())
          + f", {n_kernels:.0f} kernels per step", flush=True)

    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses not all finite: {losses}")
    expected = N_LAYERS * n_steps
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expected} each")
    if (max(sound.values()) > GRAD_TOL
            or max(moment_err.values()) > MOMENT_TOL or loss_err > LOSS_TOL):
        raise AssertionError("flash-attention training disagrees with dense")
    if (min(control_err.values()) <= GRAD_TOL
            or min(control_moment.values()) <= MOMENT_TOL
            or min(control_run_loss.values()) <= LOSS_TOL):
        raise AssertionError(
            "a wrong key mask stays within GRAD_TOL, MOMENT_TOL or "
            "LOSS_TOL: the training check cannot tell a faulty kernel")
    return launches


def build_kernels():
    """Build every CUDA source, one nvcc each, all started together."""
    seconds, errors = {}, {}

    def build(name):
        try:
            seconds[name] = _build.build(name)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=build, args=(name,))
               for name in ("flash_attention", "flash_attention_bwd")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")
    print("build: " + ", ".join(f"{name}.cu in {sec:.1f} s" for name, sec in
                                seconds.items())
          + f" (0.0: already built); wall {time.perf_counter() - t0:.1f} s",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=128)
    parser.add_argument("--train-steps", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU only", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_kernels()
    gen = torch.Generator().manual_seed(args.seed)
    fwd = kernel_phase(gen)
    bwd = bwd_kernel_phase(gen)

    with tempfile.TemporaryDirectory() as workdir:
        served = serving_phase(args.seed, args.requests, card, workdir)
    trained = training_phase(args.seed, args.train_steps, card)
    # launches: the count in this slice's main path (training); the serving
    # path's flash_fwd count stands beside it.
    fwd["launches_by_path"] = {"serving": served,
                               "training": trained["flash_fwd"]}
    records = [fwd, *bwd]
    for record in records:
        record["launches"] = trained[record["name"]]
        record["max_err"] = record["max_abs_err"]
        record["card"] = card
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
