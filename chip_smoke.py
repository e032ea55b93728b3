#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--seed N] [--requests N] [--train-steps N]
                          [--generate-requests N]

Phases (any failure raises and the script exits non-zero):

  1. setup — print the card and its power limit, turn TF32 off, build the
     CUDA sources from ``tpu_pipelines_torch/csrc`` (one nvcc each, all
     started together) and print the build times;
  2. kernels — print the forward, backward and decode kernels' registers,
     spills and shared memory per instantiation (the decode kernel's also
     at each timed shape: its splits S, the cluster size and the clusters
     the card holds at once); hold each kernel against its plain PyTorch
     version on the card at its main path's shapes and at edge cases
     (ragged length, causal, an all-masked batch row, a masked 64-key block
     inside a row, fp16/f32, strided inputs, the decode kernel's arena
     slices, int32, bool and batch-stride-0 bool masks, L = 1, split-KV
     shapes with uneven spans, all-masked splits and clusters of 2 to 8,
     and a 4096-key cache), and time it beside its plain version, the
     one-call PyTorch yardstick and its bound (the forward at the serving,
     the training and the BERT DAG's shapes, the backward kernels and Dvec
     at the training and the BERT DAG's shapes, the decode kernel at the
     beam-served, the long-cache (B=32 and B=4, L=4096), the long engine
     bucket's and the T5 DAG's BulkInferrer shapes); the forward and
     backward kernels also against a control (fed the mask shifted by one
     key) that must miss; every kernel repeated bit for bit; hold the
     attention's gradients against autograd through dense attention in
     f32;
  3. serving — export a BERT-base payload (full width, random weights from
     ``--seed``) with flash attention, serve it with ``ModelServer`` on the
     card with micro-batching, send concurrent REST ``:predict`` requests,
     and check every reply against the same weights served with dense
     attention (and that a wrong key mask would fail that check), and that
     every device batch launched the flash kernel once per layer;
  4. generate — export a T5-small payload (full width, random weights from
     ``--seed``, flash decode, beam 4, 128 decode steps, eos 3), serve it
     with ``ModelServer`` on the card, send ``:generate`` requests of 1-4
     rows from 8 concurrent clients: every reply 200 with [rows, 128] ids,
     the decode kernel launched once per decoder layer and pass, the
     teacher-forced logits of the served tokens against dense decode
     attention (and two controls around the kernel outside that
     tolerance); report latency, tokens/s and a profiled decode step;
  5. engine — the continuous-batching ``GenerativeEngine`` over the same
     payload (batch 8, pages of 32), warmed, then 24 sequences with ragged
     prompts and budgets from threads: every stream ends at EOS or its
     budget, one kernel launch per layer per prefill and step, no bucket
     first run after warm(); report steps/s, tokens/s, occupancy and how
     many streams equal the isolated greedy decode;
  6. engine_long — the engine over the same weights at a 2048-key cache
     (kv buckets 256/512/1024/2048), 8 sequences with budgets of 1100-1400
     tokens from threads, submitted LONG_STAGGER steps apart: every stream
     ends, one kernel launch per layer per prefill and step, the 2048
     bucket runs, no bucket first run after warm(); one step of the 2048
     bucket (its deepest row past 1024 keys, the rows at ragged positions)
     is replayed from a copy of its inputs with dense decode attention (its
     logits within DECODE_LOGIT_TOL of the kernel's step), with each decode
     call held against the plain version (within OUT_TOL), and under two
     controls around the kernel (the validity one short; the split that
     holds the current position lost), each of which must miss OUT_TOL at
     the attention output (the split lost also DECODE_LOGIT_TOL at the
     logits); report steps/s and tokens/s;
  7. training — fine-tune BERT-base (full width, bf16, dropout 0.1, random
     init from ``--seed``) through ``train_loop`` at batch 256 x 128 with
     ragged lengths, the first step eager and every later one a replay of
     one captured CUDA graph: every loss finite, each of the four
     attention kernels (forward, Dvec, dq, dk/dv) launched once per layer
     and step (counted at replay), one capture and a replay for every
     step after the first, no compile after warm-up; the losses and final
     q/k/v weights equal, bit for bit, to the same steps run eagerly (and
     a control re-seeded with the previous step's seed that differs); a
     last batch of another size captured once more (one compile after
     warm-up); the first step's q/k/v projection gradients, the loop's
     AdamW first moment of those weights after its last step, and every
     step's loss within tolerance of the same run with dense attention
     (and two wrong-mask controls outside each); report examples/s/chip
     of two graph runs and the eager steps, MFU, peak memory of graph and
     eager, the captured AdamW update fused and foreach, and a profiled
     step, eager and replayed;
  8. taxi_dag — the Chicago-taxi DAG (all nine nodes of
     ``tpu_pipelines_torch/examples/taxi_pipeline.py``) through
     ``LocalDagRunner(device="cuda")`` over a CSV of TAXI_ROWS rows made
     from ``--seed`` (the value ranges and categories of
     tests/testdata/taxi_sample.csv, empty hour and company fields), 200
     steps at batch 32: every node COMPLETE, the Evaluator and the
     InfraValidator bless, the Pusher pushes; a rerun is all cache hits;
     the Transform ran on the card, where the first chunk of each split
     equals apply_host bit for bit but for log_fare_z (within its log1p
     bound), and a graph with every z-score mean shifted by one std misses
     that bound; the card's float64 analyzer states equal numpy's within
     1e-12; the Trainer's losses are finite, its exported params were on
     the card, no capture after warm-up; the pushed payload predicts raw
     rows on the card within 1e-5 of the CPU, and the Evaluator's metrics
     equal the same evaluation on the CPU within 1e-5; report each node's
     wall time, Transform rows/s on the card and apply_host, a profiled
     chunk's idle share, training and evaluation examples/s.  The DAG
     launches none of the attention kernels;
  9. bert_dag — the BERT-base fine-tune DAG (the six nodes of
     ``tpu_pipelines_torch/examples/bert_pipeline.py``: CsvExampleGen ->
     StatisticsGen -> SchemaGen -> Transform (tokenize) -> Trainer ->
     Evaluator) through ``LocalDagRunner(device="cuda")`` at BERT_BASE
     (batch 256, lr 2e-5, sequences of the tokenizer's 64) with
     ``attn_impl "flash"`` set in the Trainer's hyperparameters, 100
     steps, over BERT_DAG_ROWS made-up reviews from ``--seed``: every node
     COMPLETE, a rerun all cache hits with no launch; the counters, read
     from inside the runner, hold each backward kernel at 12 x 100 and the
     forward at 12 x (100 + the Trainer's eval batches + the Evaluator's);
     one capture, a replay a step, no compile after warm-up; the
     Transform's first chunk of each split on the card == apply_host bit
     for bit; the payload's predict of raw rows == predict_transformed of
     the materialized rows bit for bit; the Evaluator's logits, loss and
     accuracy on two batches against the same payload with dense
     attention (bounds from LOGIT_TOL), a shifted-mask control missing
     it; report node seconds, tokenize rows/s, examples/s, checkpoint
     seconds, evaluation examples/s and accuracy, a replayed step's idle
     share;
 10. t5_dag — the T5-small seq2seq DAG (``examples/t5_pipeline.py``, its
     BulkInferrer beam-decoding the raw eval split, beam 4, 32 steps,
     batch 64) at T5_SMALL with flash decode attention, 100 steps, over
     T5_DAG_PAIRS made-up pairs: every node COMPLETE, a rerun all cache
     hits; the Trainer (dense: T5's self-attention carries a relative
     bias) launches nothing, one capture, no compile after warm-up; one
     prediction row of 32 ids per eval row, in the input's order; the
     decode kernel launched 6 layers x 32 passes x batches; the first and
     last batch decoded again from raw rows (the payload's embedded
     transform) == from the materialized rows == the node's rows; the
     first batch's teacher-forced logits against dense decode attention
     within DECODE_LOGIT_TOL, the two controls outside it.

After the last phase it prints the whole script's seconds.  The last
three lines are the ``kernels`` JSON record, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device":
{...}}``.  Without CUDA the script exits 2 before printing any result.
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
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.examples import bert_module, t5_module
from tpu_pipelines_torch.models import t5 as t5m
from tpu_pipelines_torch.models import transformer as tfm
from tpu_pipelines_torch.models.bert import (
    DEFAULT_HPARAMS,
    build_bert_model,
    init_bert_weights,
)
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.ops import _build
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.ring_attention import dense_attention
from tpu_pipelines_torch.serving.generative import GenerativeEngine
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model
from tpu_pipelines_torch.trainer.train_loop import (
    TrainState,
    _peak_flops_per_chip,
    _step_seed,
    _TrainStep,
    step_generator,
)

REPO = os.path.dirname(os.path.abspath(__file__))
BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples", "bert_module.py")
T5_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples", "t5_module.py")

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
# That holds for the decode kernel and the f32 forward.  The bf16/fp16
# forward also rounds p to the input dtype before O = p v, as SDPA and dense
# bf16 attention do, while the plain version keeps p in f32: per element
#   |out - ref| <= u * term + L * 2^-24 * max|ref| + rtol * |ref| + atol
# with term = sum_k (p_k / l) |v_k| (fa.fwd_rounding_terms) and u =
# fa.UNIT_ROUNDOFF (2^-8 bf16, 2^-11 fp16); L * 2^-24 * max|ref| covers the
# order of the L-term f32 sums (see F32_EPS).  The kernel fed the mask
# shifted by one key must land above that bound, on out and on lse.  The
# LSE is f32 in both (the tensor cores accumulate q.k in f32, and the
# kernel's exp2 is the SFU's, relative error ~2^-22).
OUT_TOL = {  # dtype: (rtol, atol)
    torch.bfloat16: (2.0 ** -7, 1e-5),
    torch.float16: (2.0 ** -10, 1e-6),
    torch.float32: (1e-6, 1e-6),
}
LSE_TOL = (1e-6, 1e-5)
# Served logits, flash vs dense attention, bf16 compute: both round the
# softmax probabilities to bf16 before P.V, dense after normalising and
# flash before (against each 32-key chunk's running max), so the two drift
# apart by bf16 rounding through 12 layers.  The serving phase also runs
# controls (the flash payload fed a wrong key mask) and fails unless each
# of them lands above this tolerance.  On an H100 80GB HBM3 (700 W) at
# --seed 0 the sound gap was 7.5e-3 (8.4e-3 with a forward that kept p in
# f32) and the controls 1.98e-1 and 1.91e-1: the tolerance sits near their
# geometric mean.
LOGIT_TOL = 4e-2
N_LAYERS = DEFAULT_HPARAMS["n_layers"]
SEQ_LEN = 128
# The BERT DAG's sequence length: its tokenizer's MAX_LEN.
PIPELINE_LEN = 64
# Backward kernels vs their plain versions, from the same q, k, v, dO, lse
# and Dvec.  Each gradient element may land one rounding step of the output
# dtype away (OUT_TOL's rtol), plus an absolute term for elements that
# cancel: two orders of a sum of L terms differ by at most about L * 2^-24
# of the sum of |terms|, taken as L * 2^-24 * max|ref| of the tensor.  The
# f32 kernels differ from the plain version only in that order.  The bf16
# and fp16 kernels also round p and dS to the input dtype before the second
# products (dV = p^T dO, dK = scale dS^T q, dq = scale dS k), as SDPA and
# dense bf16 attention do, while the plain version keeps them in f32: that
# moves each element by at most u = fa.UNIT_ROUNDOFF (2^-8 bf16, 2^-11
# fp16) times its sum of |terms| (fa.bwd_rounding_terms: |p|^T |dO|,
# scale |dS|^T |q|, scale |dS| |k|).  So per element
#   |got - ref| <= u * term + L * 2^-24 * max|ref| + rtol * |ref|,
# and a control (the kernels fed the mask shifted by one key) must land
# above that bound, or it could hide a fault.  Dvec: two orders of a sum of
# D f32 products differ by at most 2 * D * 2^-24 of the row's sum of
# |dO * O|.
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
    """Mean device ms per call on the current stream, by CUDA events.

    The timed launches queue behind a device-side sleep sized to outlast
    their host enqueue time (twice the warm-up's enqueue time, in cycles of
    a 2 GHz clock, above the H100's top SM clock, so the sleep lasts at
    least that long), so the events bracket back-to-back device work: a
    wrapper whose Python costs more than its kernel does not inflate the
    kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * iters * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ kernels

# name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs;
# "serving" and "training" are the BERT-base paths' shapes, "pipeline" the
# BERT DAG's (its tokenizer's max_len), "hole" masks one whole interior
# 64-key block of every row.
KERNEL_CASES = [
    ("serving", 32, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("training", TRAIN_BATCH, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged",
     False),
    ("pipeline", TRAIN_BATCH, PIPELINE_LEN, 12, 64, torch.bfloat16, False,
     "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
    ("hole", 2, 200, 4, 64, torch.bfloat16, False, "hole", False),
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
    if mask_kind == "hole":  # keys 64..127 masked in every row, the rest allowed
        mask = torch.ones(b, l, dtype=torch.int32)
        mask[:, 64:128] = 0
        return (*tensors, mask.to(dev))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if mask_kind == "empty_row":
        mask[1] = 0
    return (*tensors, mask.to(dev))


def fwd_ratio(out, ref, term, dtype, l):
    """max |out - ref| over the forward's bound for ``dtype`` (see
    OUT_TOL): at most 1 within tolerance."""
    if dtype == torch.float32:
        return tol_ratio(out, ref, OUT_TOL[dtype])
    return rounding_ratio(out, ref, term, dtype, l, atol=OUT_TOL[dtype][1])


def fwd_resources():
    """Print the forward kernel's registers, local memory and dynamic
    shared memory (at L = SEQ_LEN) for every dtype and head dim (f32: the
    FMA kernel; bf16, fp16: the tensor-core kernel); returns them for the
    main paths' instantiation (bf16, D = 64)."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        print(f"kernel flash_fwd resources {dtype}: " + "; ".join(
            "D={d} {registers} registers, {local_bytes} B local, "
            "{shared_bytes} B shared".format(
                d=d, **fa.fwd_kernel_info(dtype, d, SEQ_LEN))
            for d in fa.HEAD_DIMS), flush=True)
    return fa.fwd_kernel_info(torch.bfloat16, 64, SEQ_LEN)


def kernel_phase(gen):
    """Every forward case within its bound, its shifted-mask control above
    it on out and lse, repeats bit for bit, all-masked rows exact; returns
    the flash_fwd record (without launches) measured at the serving shape,
    with the training shape's times beside them."""
    resources = fwd_resources()
    max_out_err = max_lse_err = 0.0
    timings = {}
    for name, b, l, h, d, dtype, causal, mask_kind, strided in KERNEL_CASES:
        q, k, v, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        again = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, kv_mask=mask
        )
        term = fa.fwd_rounding_terms(q, k, v, causal=causal, kv_mask=mask)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_ratio = fwd_ratio(out, ref_out, term, dtype, l)
        lse_ratio = tol_ratio(lse, ref_lse, LSE_TOL)
        repeat = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ok = (
            torch.isfinite(out.float()).all().item()
            and out_ratio <= 1.0 and lse_ratio <= 1.0 and repeat
        )
        exact = ""
        if mask_kind == "empty_row":
            zero = (out[1].abs().max().item() == 0.0
                    and bool((lse.view(b, h, l)[1] == fa.NEG_INF).all().item()))
            exact = f"; all-masked row out exactly 0, lse exactly -1e30: {zero}"
            ok = ok and zero
        control = "n/a (no mask)"
        if mask is not None:
            wrong_out, wrong_lse = fa.flash_attention_forward(
                q, k, v, causal=causal, kv_mask=torch.roll(mask, 1, dims=1))
            controls = (fwd_ratio(wrong_out, ref_out, term, dtype, l),
                        tol_ratio(wrong_lse, ref_lse, LSE_TOL))
            control = f"out {controls[0]:.3g}, lse {controls[1]:.3g}"
            ok = ok and min(controls) > 1.0
        bound = ("the f32 tol" if dtype == torch.float32
                 else f"the bound (u {fa.UNIT_ROUNDOFF[dtype]:g})")
        print(f"kernel flash_fwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided} "
              f"max|out-ref|={out_err:.3e} ({out_ratio:.3f} of {bound}) "
              f"max|lse-ref|={lse_err:.3e} ({lse_ratio:.3f} of tol "
              f"{LSE_TOL[1]:g} + {LSE_TOL[0]:g}*|ref|); shifted-mask control "
              f"{control} (each must exceed 1); repeat bit for bit: "
              f"{repeat}{exact}", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd {name}: kernel disagrees with "
                                 "its plain version, a control stays within "
                                 "the bound, or a repeat differs")
        max_out_err = max(max_out_err, out_err)
        max_lse_err = max(max_lse_err, lse_err)
        if name in ("serving", "training", "pipeline"):
            timings[name] = fwd_timing(name, q, k, v, mask, causal)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_pipelines_torch/csrc/flash_attention.cu",
        "replaces": "tpu_pipelines/ops/flash_attention.py:59",
        "tpu_kernel": "_fwd_kernel",
        **timings["serving"],
        **{f"{path}_{key}": timings[path][key]
           for path in ("training", "pipeline")
           for key in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")},
        "max_abs_err": max_out_err,
        "lse_max_abs_err": max_lse_err,
        **resources,
    }


def fwd_timing(name, q, k, v, mask, causal):
    b, l, h, d = q.shape
    item = q.element_size()
    ms = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, kv_mask=mask))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask), iters=20, warmup=3)
    # Yardstick only: one PyTorch call computing the same function (no row
    # of these cases is fully masked, where SDPA and the kernel would
    # differ).
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
    print(f"kernel flash_fwd {name} shape: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms); bound {max(t_bytes, t_ops)*1e3:.4f} "
          f"ms ({bytes_moved} bytes, {ops} ops)", flush=True)
    return {
        "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


# (name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs)
# for the backward kernels; "training" is the fine-tune phase's shape,
# "pipeline" the BERT DAG's, "hole" masks one whole interior 64-key block
# of every row.
BWD_CASES = [
    ("training", TRAIN_BATCH, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("pipeline", TRAIN_BATCH, PIPELINE_LEN, 12, 64, torch.bfloat16, False,
     "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
    ("hole", 2, 200, 4, 64, torch.bfloat16, False, "hole", False),
    ("bf16_d16_causal", 3, 96, 2, 16, torch.bfloat16, True, "ragged", False),
]


def rounding_ratio(got, want, term, dtype, l, atol=0.0):
    """max |got - want| over the per-element bound of a 16-bit kernel that
    rounds p (and dS) before its second products (see F32_EPS and
    OUT_TOL): at most 1 within tolerance."""
    want = want.double()
    bound = (fa.UNIT_ROUNDOFF[dtype] * term.double()
             + l * F32_EPS * want.abs().max() + OUT_TOL[dtype][0] * want.abs()
             + atol)
    err = (got.double() - want).abs()
    return torch.where(err == 0, 0.0, err / bound).max().item()


def bwd_resources():
    """Print each backward kernel's registers, local memory and dynamic
    shared memory (at L = SEQ_LEN) for every dtype and head dim; returns
    them for the training instantiation (bf16, D = 64)."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            parts = []
            for kernel in ("dq", "dkv"):
                info = fa.bwd_kernel_info(kernel, dtype, d, SEQ_LEN)
                parts.append(f"{kernel} {info['registers']} registers, "
                             f"{info['local_bytes']} B local, "
                             f"{info['shared_bytes']} B shared")
            print(f"kernel flash_bwd resources {dtype} D={d}: "
                  + "; ".join(parts), flush=True)
    return {kernel: fa.bwd_kernel_info(kernel, torch.bfloat16, 64, SEQ_LEN)
            for kernel in ("dq", "dkv")}


def bwd_kernel_phase(gen):
    """Every backward case within tolerance, its shifted-mask control above
    it, repeats bit for bit, masked keys and rows exact zeros, Dvec within
    its bound, the gradients against dense attention; returns the
    flash_bwd_dq and flash_bwd_dkv records (without launches) measured at
    the training shape, with the BERT DAG's shape's times beside them."""
    resources = bwd_resources()
    max_err = {"dq": 0.0, "dkv": 0.0, "dvec": 0.0}
    timed = {}
    for name, b, l, h, d, dtype, causal, mask_kind, strided in BWD_CASES:
        q, k, v, dout, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind,
                                            strided, n=4)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        dvec = fa.flash_bwd_dvec(out, dout)
        args = (q, k, v, dout, lse, dvec)

        def kernels(kv_mask):
            return (fa.flash_bwd_dq(*args, causal=causal, kv_mask=kv_mask),
                    *fa.flash_bwd_dkv(*args, causal=causal, kv_mask=kv_mask))

        grads = kernels(mask)
        again = kernels(mask)
        torch.cuda.synchronize()
        ref_dvec = fa._dvec(out, dout)
        dvec_bound = 2 * d * F32_EPS * (dout.float() * out.float()).abs().sum(-1)
        dvec_bound = dvec_bound.permute(0, 2, 1).reshape(b * h, l)
        dvec_err = (dvec - ref_dvec).abs()
        dvec_ratio = torch.where(dvec_err == 0, 0.0,
                                 dvec_err / dvec_bound).max().item()
        max_err["dvec"] = max(max_err["dvec"], dvec_err.max().item())
        refs = (fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask),
                *fa.flash_bwd_dkv_reference(*args, causal=causal, kv_mask=mask))
        terms = fa.bwd_rounding_terms(*args, causal=causal, kv_mask=mask)
        ratios = [rounding_ratio(got, want, term, dtype, l)
                  for got, want, term in zip(grads, refs, terms)]
        ok = (all(torch.isfinite(g.float()).all().item() for g in grads)
              and max(ratios) <= 1.0 and dvec_ratio <= 1.0)
        repeat = all(torch.equal(g, r) for g, r in zip(grads, again))
        zeros = ""
        if mask_kind == "empty_row":  # the all-masked batch row
            zero = all(g[1].abs().max().item() == 0.0 for g in grads)
            zeros = f"; all-masked row exactly 0: {zero}"
            ok = ok and zero
        if mask_kind == "hole":  # the masked block's keys get nothing
            zero = all(g[:, 64:128].abs().max().item() == 0.0 for g in grads[1:])
            zeros = f"; masked key block's dk, dv exactly 0: {zero}"
            ok = ok and zero
        controls = []
        if mask is not None:
            shifted = kernels(torch.roll(mask, 1, dims=1))
            controls = [rounding_ratio(got, want, term, dtype, l)
                        for got, want, term in zip(shifted, refs, terms)]
            ok = ok and min(controls) > 1.0
        for kernel, got, want in zip(("dq", "dkv", "dkv"), grads, refs):
            max_err[kernel] = max(max_err[kernel], (got.double() - want.double())
                                  .abs().max().item())
        print(f"kernel flash_bwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided}: "
              + ", ".join(f"{g} {r:.3f}" for g, r in zip(("dq", "dk", "dv"), ratios))
              + f" of the bound (u {fa.UNIT_ROUNDOFF[dtype]:g}); Dvec "
              f"{dvec_ratio:.3f} of its bound; shifted-mask control "
              + (", ".join(f"{g} {r:.3g}" for g, r in zip(("dq", "dk", "dv"), controls))
                 or "n/a (no mask)")
              + f" (each must exceed 1); repeat bit for bit: {repeat}{zeros}",
              flush=True)
        if not (ok and repeat):
            raise AssertionError(f"flash_bwd {name}: kernels disagree with "
                                 "their plain versions, a control stays "
                                 "within the bound, or a repeat differs")
        if name in ("training", "pipeline"):
            timed[name] = bwd_timing(name, q, k, v, dout, out, lse, dvec, mask)
    records = timed["training"]
    for record, pipeline in zip(records, timed["pipeline"]):
        record.update({f"pipeline_{key}": value for key, value in
                       pipeline.items() if key in ("shape", "ms", "plain_ms",
                                                   "bound_ms", "library_ms",
                                                   "dvec_ms", "dvec_plain_ms",
                                                   "dvec_bound_ms",
                                                   "backward_ms")})
    for kernel, record in zip(("dq", "dkv"), records):
        record["max_abs_err"] = max_err[kernel]
        record.update(resources[kernel])
    records[0]["dvec_max_abs_err"] = max_err["dvec"]
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


def bwd_timing(label, q, k, v, dout, out, lse, dvec, mask):
    b, l, h, d = q.shape
    item = q.element_size()
    args = (q, k, v, dout, lse, dvec)
    ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq(*args, kv_mask=mask)),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv(*args, kv_mask=mask)),
    }
    plain_ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq_reference(*args, kv_mask=mask),
                      iters=10, warmup=2),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(*args, kv_mask=mask),
                       iters=10, warmup=2),
    }
    dvec_ms = time_ms(lambda: fa.flash_bwd_dvec(out, dout))
    dvec_plain_ms = time_ms(lambda: fa._dvec(out, dout), iters=50)
    total_ms = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, dout, kv_mask=mask))
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
        print(f"kernel flash_bwd_{kernel} {label} shape: {ms[kernel]:.4f} ms "
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
    # Dvec: O and dO read once, the f32 [B*H, L] written once; 2 f32
    # operations per element on the FMA units.
    dvec_bytes = 2 * b * l * h * d * item + b * h * l * 4
    dvec_bound_ms = max(dvec_bytes / HBM_BYTES_PER_S,
                        2 * b * l * h * d / PEAK_OPS_PER_S[torch.float32]) * 1e3
    records[0].update({"dvec_ms": dvec_ms, "dvec_plain_ms": dvec_plain_ms,
                       "dvec_bound_ms": dvec_bound_ms,
                       "backward_ms": total_ms})
    print(f"kernel flash_bwd_dvec {label} shape: {dvec_ms:.4f} ms (plain "
          f"{dvec_plain_ms:.4f} ms); bound {dvec_bound_ms:.4f} ms "
          f"({dvec_bytes} bytes)", flush=True)
    print(f"kernel flash backward {label} shape: Dvec {dvec_ms:.4f} ms + dq "
          f"{ms['dq']:.4f} ms + dkv {ms['dkv']:.4f} ms = "
          f"{dvec_ms + ms['dq'] + ms['dkv']:.4f} ms; whole backward "
          f"(flash_attention_backward) {total_ms:.4f} ms; sdpa backward "
          f"{library_ms:.4f} ms", flush=True)
    return records


# (name, batch, cache len, heads, head_dim, dtype, validity, bias, arena,
# mask) for the decode kernel.  "served" is the beam-served step (4 rows x 4
# beams, every row at one position, T5's broadcast bias, the expanded bool
# mask of a scalar position), "engine" an engine bucket (a [:b, :kv] slice
# of an arena, ragged positions, per-row bias, a bool mask), "long_cache"
# the shape whose bound is the k/v bytes alone, "long_cache_b4" a one-row
# beam request at that cache, "engine_long" the long-cache engine run's
# 2048 bucket, "bulk_infer" the T5 DAG's BulkInferrer beam step (64 rows x
# 4 beams at its max_decode_len).  Validity: "pos" keys <= L/2 in every
# row, "ragged" keys <= a random position per row, "ragged_1500" the same
# with positions < 1500, "eighth" positions < L/8 (every split past the
# first holds no allowed key), "hole" ragged with keys 300..699 masked, "empty_row" ragged with
# row 1 all masked, "full" every key.  Mask: "int32", "bool", or
# "bool_expanded" (one bool row expanded over the batch, batch stride 0;
# needs "pos" or "full" validity).  The kernel takes S =
# fa.decode_splits(B, H, L, SMs) CTAs per (batch, head): the split_* cases
# cover uneven spans with L not a multiple of 64, masked splits, an empty
# row across splits, clusters of 3 and 7, f32 and D=128 (on an H100 SXM's
# 132 SMs "long_cache" runs 2, "engine_long" 5, "long_cache_b4" 8);
# "chunks" (S = 1, L = 4500) walks
# three 2048-key mask chunks; the cases with L <= 256 (4 blocks) run S = 1
# without a cluster.
DECODE_CASES = [
    ("served", 16, 128, 8, 64, torch.bfloat16, "pos", "broadcast", False,
     "bool_expanded"),
    ("engine", 8, 64, 8, 64, torch.bfloat16, "ragged", "per_row", True, "bool"),
    ("len_1", 4, 1, 8, 64, torch.bfloat16, "pos", "broadcast", False, "int32"),
    ("len_100", 4, 100, 8, 64, torch.bfloat16, "ragged", "per_row", False,
     "int32"),
    ("empty_row", 4, 128, 8, 64, torch.bfloat16, "empty_row", "per_row", False,
     "int32"),
    ("no_bias", 4, 128, 8, 64, torch.bfloat16, "ragged", "none", False, "int32"),
    ("fp16", 4, 100, 8, 64, torch.float16, "ragged", "per_row", True, "int32"),
    ("f32", 4, 100, 8, 64, torch.float32, "ragged", "broadcast", False, "int32"),
    ("d16", 4, 100, 8, 16, torch.bfloat16, "ragged", "per_row", False, "int32"),
    ("d32", 4, 100, 8, 32, torch.bfloat16, "ragged", "broadcast", False, "bool"),
    ("d128", 4, 100, 8, 128, torch.bfloat16, "ragged", "per_row", True, "int32"),
    ("split_ragged_len", 4, 1100, 8, 64, torch.bfloat16, "ragged", "per_row",
     False, "int32"),
    ("split_masked", 4, 2048, 8, 64, torch.bfloat16, "eighth", "broadcast",
     False, "bool"),
    ("split_empty_row", 4, 2048, 8, 64, torch.bfloat16, "empty_row", "per_row",
     False, "int32"),
    ("split_hole", 4, 1100, 8, 64, torch.bfloat16, "hole", "per_row", True,
     "bool"),
    ("split_bool_expanded", 4, 1000, 8, 64, torch.bfloat16, "pos", "broadcast",
     False, "bool_expanded"),
    ("split_f32", 4, 1100, 8, 64, torch.float32, "ragged", "per_row", True,
     "int32"),
    ("split_d128", 4, 2048, 8, 128, torch.bfloat16, "ragged", "per_row", True,
     "bool"),
    ("split_s3", 11, 1000, 8, 64, torch.bfloat16, "ragged", "broadcast", False,
     "int32"),
    ("split_s7", 5, 1000, 8, 64, torch.float16, "ragged", "per_row", False,
     "bool"),
    ("chunks", 34, 4500, 8, 64, torch.bfloat16, "ragged", "per_row", False,
     "int32"),
    ("long_cache", 32, 4096, 8, 64, torch.bfloat16, "full", "broadcast", False,
     "int32"),
    ("long_cache_b4", 4, 4096, 8, 64, torch.bfloat16, "full", "broadcast",
     False, "bool_expanded"),
    ("engine_long", 8, 2048, 8, 64, torch.bfloat16, "ragged_1500", "per_row",
     True, "bool"),
    ("bulk_infer", 4 * 64, 32, 8, 64, torch.bfloat16, "pos", "broadcast", False,
     "bool_expanded"),
]
DECODE_TIMED = ("served", "long_cache", "long_cache_b4", "engine_long",
                "bulk_infer")


def decode_inputs(gen, b, l, h, d, dtype, validity, bias_kind, arena, mask_kind):
    dev = "cuda"
    q = torch.randn(b, 1, h, d, generator=gen).to(dev, dtype)
    if arena:  # [:b, :l] slices of a larger [B, L, 2, H, D] cache
        cache = torch.randn(b + 2, l + 32, 2, h, d, generator=gen).to(dev, dtype)
        k, v = cache[:b, :l, 0], cache[:b, :l, 1]
    else:
        k, v = (torch.randn(b, l, h, d, generator=gen).to(dev, dtype)
                for _ in range(2))
    if validity == "full":
        pos = torch.full((b,), l - 1)
    elif validity == "pos":
        pos = torch.full((b,), l // 2)
    elif validity == "eighth":
        pos = torch.randint(0, l // 8, (b,), generator=gen)
    elif validity == "ragged_1500":
        pos = torch.randint(0, 1500, (b,), generator=gen)
    else:
        pos = torch.randint(0, l, (b,), generator=gen)
    mask = torch.arange(l)[None, :] <= pos[:, None]
    if validity == "empty_row":
        mask[1] = False
    if validity == "hole":
        mask[:, 300:700] = False
    bias = None
    if bias_kind != "none":
        rows = 1 if bias_kind == "broadcast" else b
        bias = torch.randn(rows, h, 1, l, generator=gen).to(dev)
    if mask_kind == "bool_expanded":
        assert validity in ("pos", "full")   # every row the same
        return q, k, v, mask[:1].to(dev).expand(b, l), bias
    return q, k, v, mask.to(dev, torch.int32 if mask_kind == "int32"
                            else torch.bool), bias


def decode_resources(shapes):
    """The decode kernel's registers, spills, shared memory and CTAs per SM
    per instantiation, and at each timed shape its splits S (the cluster
    size) and how many such clusters the card runs at once."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        cells = []
        for d in fa.HEAD_DIMS:
            info = fa.decode_kernel_info(dtype, d, 1)
            cells.append(f"D={d} {info['registers']} regs / "
                         f"{info['local_bytes']} B spill / "
                         f"{info['shared_bytes']} B smem / "
                         f"{info['ctas_per_sm']} CTAs per SM")
        print(f"kernel flash_decode resources {str(dtype).replace('torch.', '')}: "
              + "; ".join(cells), flush=True)
    out = {}
    for name, (b, l, h, d, dtype) in shapes.items():
        splits = fa.decode_splits(b, h, l, fa.sm_count("cuda"))
        info = fa.decode_kernel_info(dtype, d, splits)
        print(f"kernel flash_decode resources {name} (B={b} L={l} H={h} D={d}): "
              f"S={splits}, cluster size {splits}, {splits * b * h} CTAs, "
              f"{info['registers']} registers, {info['local_bytes']} B spill, "
              f"{info['shared_bytes']} B shared memory, at most "
              f"{info['max_active_clusters']} clusters at once", flush=True)
        out[name] = {"splits": splits, "registers": info["registers"],
                     "spill_bytes": info["local_bytes"],
                     "shared_bytes": info["shared_bytes"],
                     "max_active_clusters": info["max_active_clusters"]}
    return out


def decode_kernel_phase(gen):
    """Every decode case within one output ulp of the plain version and
    repeated bit for bit; returns the flash_decode record (without
    launches), timed at the DECODE_TIMED shapes."""
    max_err = 0.0
    timings = {}
    for (name, b, l, h, d, dtype, validity, bias_kind, arena,
         mask_kind) in DECODE_CASES:
        q, k, v, mask, bias = decode_inputs(gen, b, l, h, d, dtype, validity,
                                            bias_kind, arena, mask_kind)
        out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
        again = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
        torch.cuda.synchronize()
        ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask,
                                                  bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        ratio = tol_ratio(out, ref, OUT_TOL[dtype])
        ok = torch.isfinite(out.float()).all().item() and ratio <= 1.0
        repeats = torch.equal(out, again)
        if validity == "empty_row":
            ok = ok and out[1].abs().max().item() == 0.0
        print(f"kernel flash_decode {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"S={fa.decode_splits(b, h, l, fa.sm_count('cuda'))} "
              f"validity={validity} "
              f"bias={bias_kind} arena={arena} mask={mask_kind} "
              f"max|out-ref|={err:.3e} ({ratio:.3f} of tol "
              f"{OUT_TOL[dtype][1]:g} + {OUT_TOL[dtype][0]:g}*|ref|); repeat "
              f"bit for bit {repeats}", flush=True)
        if not ok or not repeats:
            raise AssertionError(f"flash_decode {name}: kernel disagrees with "
                                 "its plain version or with itself")
        max_err = max(max_err, err)
        if name in DECODE_TIMED:
            timings[name] = decode_timing(name, q, k, v, mask, bias)
    resources = decode_resources({
        name: (b, l, h, d, dtype) for (name, b, l, h, d, dtype, *_)
        in DECODE_CASES if name in DECODE_TIMED})
    for name, res in resources.items():
        timings[name].update(res)
    return {
        "name": "flash_decode",
        "route": "cuda",
        "source": "tpu_pipelines_torch/csrc/flash_decode.cu",
        "replaces": "tpu_pipelines/ops/flash_attention.py:325",
        "tpu_kernel": "_decode_kernel",
        **timings["served"],
        **{name: timings[name] for name in DECODE_TIMED if name != "served"},
        "max_abs_err": max_err,
    }


def decode_timing(name, q, k, v, mask, bias):
    b, l, h, d = k.shape
    item = q.element_size()
    iters = 200 if l <= 1024 else 50
    # Yardstick only: SDPA with the bias and the validity folded into one
    # float mask, built outside the timed region (no row here is empty).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    float_mask = torch.where((mask > 0)[:, None, None, :],
                             bias.expand(b, h, 1, l), float("-inf"))
    # Kernel and SDPA in turns, twice, each keeping its faster run: the
    # card idles while the inputs are made on the host, and the first
    # timing after an idle gap runs at lower clocks.
    runs = {"kernel": [], "sdpa": []}
    for _ in range(2):
        runs["kernel"].append(time_ms(lambda: fa.flash_decode_attention(
            q, k, v, kv_mask=mask, bias=bias), iters=iters))
        runs["sdpa"].append(time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=float_mask), iters=iters))
    ms, library_ms = min(runs["kernel"]), min(runs["sdpa"])
    plain_ms = time_ms(lambda: fa.flash_decode_attention_reference(
        q, k, v, kv_mask=mask, bias=bias), iters=20, warmup=3)
    # Least time for the same work: q read and out written once, k and v
    # read at the allowed keys only, the [B, L] mask (at its own element
    # size, once: an expanded mask is one row), the f32 bias at the allowed
    # keys only (a broadcast bias once for each key that any row allows);
    # about 4*D operations per (head, allowed key).
    allowed_keys = mask > 0
    allowed = int(allowed_keys.sum().item())
    mask_bytes = (mask.numel() if mask.stride(0) else l) * mask.element_size()
    bias_keys = (int(allowed_keys.any(dim=0).sum().item())
                 if bias.shape[0] == 1 else allowed)
    bytes_moved = (2 * q.numel() * item + 2 * allowed * h * d * item
                   + mask_bytes + bias_keys * h * 4)
    ops = 4 * d * h * allowed
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"kernel flash_decode {name} shape [{card_line()}]: {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; in turns "
          f"kernel {runs['kernel'][0]:.4f} / {runs['kernel'][1]:.4f}, sdpa "
          f"{runs['sdpa'][0]:.4f} / {runs['sdpa'][1]:.4f}); bound "
          f"{bound_ms:.4f} ms ({bytes_moved} bytes, {ops} ops)", flush=True)
    return {
        "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library": "scaled_dot_product_attention with a float mask",
    }


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


def run_clients(url, requests, n_procs=N_CLIENT_PROCS, threads=CLIENT_THREADS):
    """POST every request from ``n_procs`` processes of ``threads`` threads
    each; returns ([(code, reply, seconds)] in request order, wall seconds
    from the first request sent to the last reply)."""
    procs = []
    try:
        for c in range(n_procs):
            proc = subprocess.Popen(
                [sys.executable, "-c", CLIENT], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
            procs.append(proc)
            job = {"url": url, "threads": threads, "requests": [
                [i, requests[i]]
                for i in range(c, len(requests), n_procs)]}
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
                   if re.search(r"\bflash_fwd(_mma)?_kernel\b", e.name))
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
# batches and dropout generators: both round the softmax probabilities to
# bf16 before P.V, at different points (see LOGIT_TOL).  Three checks, each
# against two controls (flash fed no key mask, or each row's neighbour's)
# that must land above its tolerance; each tolerance sits near the
# geometric mean of the sound gap and the smaller control, measured on an
# H100 80GB HBM3 (700 W) at --seed 0 (the sound gaps in brackets are those
# of a forward that kept p in f32):
#   - GRAD_TOL bounds the relative L2 error of the first step's q/k/v
#     projection-weight gradients, which reach the weights only through
#     dq/dk/dv (sound 3.0e-2 [2.9e-2], controls 8.7e-1 and 1.04);
#   - MOMENT_TOL bounds the relative L2 error of AdamW's first moment of
#     every q/k/v projection weight after the whole train_loop run (the
#     loop's own optimizer state, an EMA of the gradients of all its
#     steps), the controls being train_loop runs fed the wrong masks
#     (sound 3.3e-2 [3.4e-2], controls 1.14 and 1.0);
#   - LOSS_TOL bounds the relative error of every step's loss in those
#     runs (sound 2.2e-3 [1.5e-3], controls 1.6e-1 and 3.8e-2).  Step 1 alone
#     cannot tell: at random init the loss stays near ln 2 whatever the
#     mask, and the runs part only as the classifier learns.
GRAD_TOL = 1.5e-1
MOMENT_TOL = 1.8e-1
LOSS_TOL = 1e-2
DEVICE = "cuda"


def training_batches(seed, vocab, n, batch=TRAIN_BATCH):
    """``n`` batches of ``batch`` x SEQ_LEN with ragged real lengths
    (8..SEQ_LEN), pad id 0 behind them, and bench.py's label rule."""
    rng = np.random.default_rng(seed + 1)
    batches = []
    for _ in range(n):
        lengths = rng.integers(8, SEQ_LEN + 1, size=batch)
        mask = np.arange(SEQ_LEN)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, vocab, size=(batch, SEQ_LEN)), 0)
        batches.append({
            "input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "label": (ids[:, 0] % 2).astype(np.int32),
        })
    return batches


QKV_WEIGHT = re.compile(r"\.attn\.(query|key|value)\.weight$")


def run_training(hp, seed, batches):
    """train_loop over ``batches``; returns (model, result, per-step losses,
    {q/k/v projection weight: AdamW's first moment after the run}, {calls
    of loss_fn, graph captures, graph replays in the run}, the run's
    capture seconds from train_compile_seconds_total)."""
    losses, optimizers = [], []
    calls = {"loss_fn": 0, "captures": 0, "replays": 0}
    capture_s = default_registry().counter(
        "train_compile_seconds_total", labels=("when",))
    capture_s0 = sum(capture_s.labels(w).get() for w in ("warmup", "steady"))

    def optimizer(params):
        optimizers.append(bert_module.adamw(TRAIN_LR)(params))
        return optimizers[-1]

    def loss_fn(*args):
        calls["loss_fn"] += 1
        return bert_module.loss_fn(*args)

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            calls[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    graph = torch.cuda.CUDAGraph
    with mock.patch.object(graph, "replay", counted("replays", graph.replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", graph.capture_begin)):
        model, result = train_loop(
            loss_fn=loss_fn,
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
    seconds = sum(capture_s.labels(w).get() for w in ("warmup", "steady"))
    return model, result, losses, moments, calls, seconds - capture_s0


def eager_training(hp, seed, batches):
    """The same steps as ``run_training`` written out eagerly: the loop's
    init, the capturable AdamW, ``step_generator(seed, s)``, a synchronous
    copy of each batch.  Returns (per-step losses, the model, examples/s
    over the steps after the first TRAIN_WINDOW, peak device bytes)."""
    torch.cuda.reset_peak_memory_stats()
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batches[0], hyperparameters=hp)
    model.to(DEVICE).train()
    opt = bert_module.adamw(TRAIN_LR)(model.parameters())
    losses = []
    for s, batch in enumerate(batches):
        if s == TRAIN_WINDOW:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
        loss, _ = bert_module.loss_fn(model, dev_batch,
                                      step_generator(seed, s, DEVICE))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    eps = (len(batches) - TRAIN_WINDOW) * TRAIN_BATCH / (time.perf_counter() - t0)
    return ([x.item() for x in losses], model, eps,
            torch.cuda.max_memory_allocated())


def replay_step_breakdown(hp, seed, batch, iters=3):
    """The train loop's step object on one batch: the first step (eager,
    then the capture), then windows of TRAIN_WINDOW replays back to back
    with one synchronize each, as the loop runs them, profiled like
    train_step_breakdown and given per step: (wall_ms, profiled wall_ms,
    busy_ms, kernels per step)."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    state = TrainState(step=0, model=model, seed=seed,
                       optimizer=bert_module.adamw(TRAIN_LR)(model.parameters()))
    runner = _TrainStep(state, bert_module.loss_fn, torch.device(DEVICE))
    dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    runner.run(dev_batch, 0)

    def window(i):
        for j in range(TRAIN_WINDOW):
            runner.run(dev_batch, 1 + i * TRAIN_WINDOW + j)
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, _, n_kernels = profiled(window, iters)
    return (wall_ms / TRAIN_WINDOW, profiled_ms / TRAIN_WINDOW,
            busy_ms / TRAIN_WINDOW, n_kernels / TRAIN_WINDOW)


def adamw_timing(model):
    """Device ms of one captured AdamW update of ``model``'s parameters,
    capturable foreach against capturable fused (optax's defaults, the
    learning rate of the run), each replayed from its own CUDA graph."""
    times = {}
    for fused in (False, True):
        params = [p.detach().clone().requires_grad_() for p in model.parameters()]
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=DEVICE) * 1e-3
        opt = torch.optim.AdamW(params, lr=TRAIN_LR, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4, capturable=True,
                                fused=fused)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            opt.step()                       # builds the state
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            opt.step()
        times["fused" if fused else "foreach"] = time_ms(graph.replay, iters=20,
                                                         warmup=3)
        del opt, params, graph
    return times


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

    wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, iters)
    by_kernel = {
        name: sum(us for kernel, us in by_name.items()
                  if re.search(rf"\b{name}(_mma)?_kernel\b", kernel)) / iters / 1e3
        for name in ("flash_fwd", "flash_bwd_dvec", "flash_bwd_dq",
                     "flash_bwd_dkv")
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for kernel, us in top:
        print(f"training step top kernel: {us / iters / 1e3:.3f} ms/step "
              f"{kernel[:110]}", flush=True)
    return wall_ms, profiled_ms, busy_ms, by_kernel, n_kernels


def training_phase(seed, n_steps, card):
    """The slice's main path: BERT-base fine-tuning through train_loop with
    flash attention.  Returns the four kernels' launches in that run."""
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash", "max_len": SEQ_LEN,
          "num_classes": 2}
    batches = training_batches(seed, hp["vocab_size"], n_steps)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.dvec_launches = 0
    model, result, losses, moments, calls, capture_s = run_training(
        hp, seed, batches)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dvec": fa.dvec_launches,
                "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    matmul_params = sum(
        p.numel() for name, p in model.named_parameters()
        if not re.search(r"(embed|pos_embed|type_embed)\.weight$", name))
    qkv = {name: p.detach().clone() for name, p in model.named_parameters()
           if QKV_WEIGHT.search(name)}
    adamw_ms = adamw_timing(model)
    del model

    # The graph run against the same steps written out eagerly (bit for
    # bit), a control re-seeded with the previous step's seed (must
    # differ), and a run whose last batch has another size (one capture
    # after warm-up).
    eager_losses, eager_model, eager_eps, eager_peak = eager_training(
        hp, seed, batches)
    qkv_equal = all(torch.equal(p, qkv[name])
                    for name, p in eager_model.named_parameters() if name in qkv)
    del eager_model
    with mock.patch("tpu_pipelines_torch.trainer.train_loop._step_seed",
                    lambda sd, st: _step_seed(sd, st - 1)):
        _, reseeded_result, reseeded_losses, _, _, _ = run_training(
            hp, seed, batches)
    reseeded_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(reseeded_losses, eager_losses))
    odd = training_batches(seed + 7, hp["vocab_size"], 1, batch=TRAIN_BATCH // 2)
    _, tail_result, tail_losses, _, tail_calls, tail_capture_s = run_training(
        hp, seed, batches[:TRAIN_WINDOW] + odd)

    _, dense_result, dense_losses, want_moments, _, _ = run_training(
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
        _, _, run_losses, got_moments, _, _ = run_training(hp, seed, fed)
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
    r_wall_ms, r_profiled_ms, r_busy_ms, r_kernels = replay_step_breakdown(
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
          "expected for each, counted at replay", flush=True)
    print(f"training graph: {calls['captures']} capture, {calls['replays']} "
          f"replays, loss_fn called {calls['loss_fn']} times (the eager first "
          f"step and the capture), capture {capture_s:.3f} s, compiles after "
          f"warm {result.compiles_after_warm}; against the same steps run eagerly: "
          f"losses {'equal' if losses == eager_losses else 'DIFFER'} bit for "
          f"bit, final q/k/v weights {'equal' if qkv_equal else 'DIFFER'} bit "
          f"for bit; control re-seeded with step s-1's seed: max rel loss gap "
          f"{reseeded_gap:.3e} (must exceed 0)", flush=True)
    print(f"training graph, last batch of {TRAIN_BATCH // 2} rows after "
          f"{TRAIN_WINDOW} of {TRAIN_BATCH}: {tail_calls['captures']} captures, "
          f"{tail_calls['replays']} replays, captures {tail_capture_s:.3f} s, "
          f"compiles after warm {tail_result.compiles_after_warm}, losses "
          + " ".join(f"{x:.5f}" for x in tail_losses), flush=True)
    print(f"training throughput [{card}]: graph "
          f"{result.anchored_examples_per_sec_per_chip} and "
          f"{reseeded_result.anchored_examples_per_sec_per_chip} "
          f"examples/s/chip anchored (two runs of the same work), eager "
          f"{eager_eps:.2f} over the same steps; peak device memory graph "
          f"{peak_bytes} bytes, eager {eager_peak} bytes; AdamW update, "
          f"captured: foreach {adamw_ms['foreach']:.4f} ms, fused "
          f"{adamw_ms['fused']:.4f} ms (the loop's: fused)", flush=True)
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
          + f", {n_kernels:.0f} kernels per step (eager)", flush=True)
    print(f"training step [{card}] graph replay, batch {TRAIN_BATCH} x "
          f"{SEQ_LEN}, windows of {TRAIN_WINDOW} replays: host wall "
          f"{r_wall_ms:.3f} ms ({r_profiled_ms:.3f} ms traced), device busy "
          f"{r_busy_ms:.3f} ms traced (idle share "
          f"{1 - r_busy_ms / r_profiled_ms:.3f}), {r_kernels:.0f} kernels per "
          "step", flush=True)

    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses not all finite: {losses}")
    expected = N_LAYERS * n_steps
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expected} each")
    if (calls != {"loss_fn": 2, "captures": 1, "replays": n_steps - 1}
            or result.compiles_after_warm != 0):
        raise AssertionError(f"training: every step after the first must be a "
                             f"replay of one capture: {calls}, compiles after "
                             f"warm {result.compiles_after_warm}")
    if losses != eager_losses or not qkv_equal:
        raise AssertionError("training: the graph run differs from the same "
                             "steps run eagerly")
    if not reseeded_gap > 0:
        raise AssertionError("training: re-seeding the dropout generator with "
                             "the previous step's seed changes no loss: the "
                             "eager check cannot tell the masks")
    if (tail_result.compiles_after_warm != 1
            or tail_calls != {"loss_fn": 3, "captures": 2,
                              "replays": TRAIN_WINDOW}
            or not all(np.isfinite(tail_losses))):
        raise AssertionError(f"training: a last batch of another size must be "
                             f"captured once more: {tail_calls}, compiles "
                             f"after warm {tail_result.compiles_after_warm}")
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


# --------------------------------------------------------- generative serving

T5_LAYERS = t5m.DEFAULT_HPARAMS["n_layers"]
DECODE_LEN = 128
BEAM = 4
EOS_ID = 3
MAX_INPUT_LEN = 64
# Teacher-forced decoder logits, the served payload (flash decode) against
# the same weights with dense decode attention, bf16 compute: dense rounds
# the softmax probabilities to bf16 before P.V, the kernel keeps them in
# f32.  Two controls (the kernel handed the validity one position short, or
# the bias row of the next position) must land above it.  Set near the
# geometric mean of the sound gap and the smaller control, measured on an
# H100 80GB HBM3 (700 W) at --seed 0: sound 2.2e-3, controls 1.9e-1 (one
# short) and 6.5e-2 (next bias row); at random init the logits' scale is
# about 0.04.
DECODE_LOGIT_TOL = 1.2e-2


def t5_hparams(attn_impl):
    return {**t5m.DEFAULT_HPARAMS, "attn_impl": attn_impl, "beam_size": BEAM,
            "max_decode_len": DECODE_LEN, "eos_id": EOS_ID,
            "max_input_len": MAX_INPUT_LEN}


def t5_requests(rng, n_requests, vocab):
    """``:generate`` bodies of 1-4 rows, real input lengths 8..64, padded to
    MAX_INPUT_LEN behind an input_mask."""
    requests = []
    for _ in range(n_requests):
        rows = int(rng.integers(1, 5))
        lengths = rng.integers(8, MAX_INPUT_LEN + 1, size=rows)
        mask = np.arange(MAX_INPUT_LEN)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, vocab, size=(rows, MAX_INPUT_LEN)), 0)
        requests.append({"inputs": {"inputs": ids.tolist(),
                                    "input_mask": mask.astype(np.int32).tolist()}})
    return requests


def generated_tokens(tokens):
    """Tokens emitted per row: up to and including the first EOS."""
    out = 0
    for row in tokens:
        row = list(row)
        out += row.index(EOS_ID) + 1 if EOS_ID in row else len(row)
    return out


def validity_one_short(q, k, v, *, kv_mask, bias=None, block_k=None):
    """Control: the kernel loses the current token's own K/V."""
    short = kv_mask.clone()
    last = short.to(torch.int32).sum(dim=1) - 1
    rows = torch.arange(short.shape[0], device=short.device)
    short[rows, last.clamp_min(0)] = False
    return fa.flash_decode_attention(q, k, v, kv_mask=short, bias=bias,
                                     block_k=block_k)


def next_position_bias(rel_pos):
    """Control: the kernel gets the bias row of the next position."""
    def wrapper(q, k, v, *, kv_mask, bias=None, block_k=None):
        length = k.shape[1]
        pos = int(kv_mask[0].sum().item()) - 1    # every row at one position
        nxt = rel_pos(length + 1, length + 1, row=pos + 1)[..., :length]
        return fa.flash_decode_attention(q, k, v, kv_mask=kv_mask,
                                         bias=nxt.contiguous(), block_k=block_k)
    return wrapper


def kernel_as(wrapper):
    """Within the block the decoder's decode attention calls ``wrapper`` (a
    control around the kernel), or the kernel's own wrapper for None."""
    return mock.patch.object(tfm, "flash_decode_attention",
                             wrapper or fa.flash_decode_attention)


def teacher_forced_gaps(flash, dense, ids, mask, tokens,
                        decode_len=DECODE_LEN):
    """Feed ``tokens`` (the served output) step by step through the flash
    payload, the dense one and the flash one under each control; returns
    {run: max |logits - dense logits| over every step}."""
    runs = {
        "sound": None,
        "validity one short": validity_one_short,
        "bias of the next position": next_position_bias(
            flash.model.decoder.rel_pos),
    }
    ids = torch.as_tensor(ids, device=DEVICE)
    mask = torch.as_tensor(mask, device=DEVICE, dtype=torch.int32)
    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    gaps = dict.fromkeys(runs, 0.0)
    with torch.inference_mode():
        states = {}
        for name, wrapper in [("dense", None), *runs.items()]:
            loaded = dense if name == "dense" else flash
            with kernel_as(wrapper):
                cache, encoded, logits = t5m.prefill_decode(
                    loaded.model, loaded.params, ids, mask, decode_len)
            states[name] = (loaded, wrapper, cache, encoded, logits)
        for t in range(decode_len):
            want = states["dense"][4]
            for name in runs:
                gaps[name] = max(gaps[name], (states[name][4] - want).abs()
                                 .max().item())
            if t + 1 == decode_len:
                break
            for name, (loaded, wrapper, cache, encoded, _) in states.items():
                with kernel_as(wrapper):
                    cache, logits = t5m._decode_one(
                        loaded.model, loaded.params, cache, tokens[:, t],
                        encoded, mask, t + 1, decode_len)
                states[name] = (loaded, wrapper, cache, encoded, logits)
    return gaps


def profiled(step, iters):
    """Host wall of ``step`` (which ends in a synchronize) and, from
    torch.profiler, the device time of the same steps: (wall_ms, profiled
    wall_ms, busy_ms, {kernel name: us summed})."""
    from torch.profiler import ProfilerActivity, profile

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
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall_ms, profiled_ms, busy_us / iters / 1e3, by_name, len(kernels) / iters


def decode_step_breakdown(loaded, ids, mask, card):
    """One beam decode step at the served shape (4 rows x 4 beams, cache
    DECODE_LEN, position DECODE_LEN / 2), profiled."""
    ids = torch.as_tensor(ids[:4], device=DEVICE).repeat_interleave(BEAM, 0)
    mask = torch.as_tensor(mask[:4], device=DEVICE,
                           dtype=torch.int32).repeat_interleave(BEAM, 0)
    tok = torch.full((ids.shape[0],), 7, dtype=torch.long, device=DEVICE)
    with torch.inference_mode():
        cache, encoded, _ = t5m.prefill_decode(loaded.model, loaded.params, ids,
                                               mask, DECODE_LEN)

        def step(_):
            t5m._decode_one(loaded.model, loaded.params, cache, tok, encoded,
                            mask, DECODE_LEN // 2, DECODE_LEN)
            torch.cuda.synchronize()

        wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, 20)
    decode_ms = sum(us for name, us in by_name.items()
                    if "flash_decode_kernel" in name) / 20 / 1e3
    print(f"generate step [{card}] beam decode step, {ids.shape[0]} rows, cache "
          f"{DECODE_LEN}, position {DECODE_LEN // 2}: host wall {wall_ms:.3f} ms "
          f"({profiled_ms:.3f} ms traced), device busy {busy_ms:.3f} ms traced "
          f"(idle share {1 - busy_ms / profiled_ms:.3f}), flash_decode "
          f"{decode_ms:.4f} ms, {n_kernels:.0f} kernels per step", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"generate step top kernel: {us / 20 / 1e3:.4f} ms/step "
              f"{name[:110]}", flush=True)


def generate_phase(seed, n_requests, card, workdir):
    """T5-small beam search through ModelServer's :generate on the card.
    Returns (flash_decode launches over the served requests, the flash
    payload, every served row's (ids, mask) for the engine phase)."""
    hp = t5_hparams("flash")
    model = t5m.init_t5_weights(t5m.build_t5_model(hp),
                                torch.Generator().manual_seed(seed))
    state = model.state_dict()
    base = os.path.join(workdir, "t5")
    export_model(serving_model_dir=os.path.join(base, "1"), params=state,
                 module_file=T5_MODULE, hyperparameters=hp)
    dense_dir = os.path.join(workdir, "t5_dense", "1")
    export_model(serving_model_dir=dense_dir, params=state,
                 module_file=T5_MODULE, hyperparameters=t5_hparams("dense"))
    del model, state

    requests = t5_requests(np.random.default_rng(seed + 3), n_requests,
                           hp["vocab_size"])
    server = ModelServer("t5", base, device="cuda")
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5:generate"
        warm, _ = run_clients(url, requests[:1], n_procs=1, threads=1)
        if warm[0][0] != 200:
            raise AssertionError(f"warm-up request answered {warm[0][0]}")
        fa.decode_launches = 0
        results, wall_s = run_clients(url, requests, n_procs=2, threads=4)
        launches = fa.decode_launches
    finally:
        server.stop()

    codes = [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"non-200 :generate replies: {sorted(set(codes))}")
    outputs = []
    for payload, (_, reply, _) in zip(requests, results):
        got = np.asarray(reply["outputs"])
        rows = len(payload["inputs"]["inputs"])
        if got.shape != (rows, DECODE_LEN) or got.dtype.kind != "i":
            raise AssertionError(f":generate reply shape {got.shape} {got.dtype}")
        outputs.append(got)
    tokens = np.concatenate(outputs)
    ids = np.concatenate([np.asarray(p["inputs"]["inputs"]) for p in requests])
    mask = np.concatenate([np.asarray(p["inputs"]["input_mask"])
                           for p in requests])
    # Each request runs DECODE_LEN decoder passes (the step-0 pass of
    # prefill_decode, then DECODE_LEN - 1 beam steps), each launching the
    # kernel once per decoder layer.
    expected = T5_LAYERS * DECODE_LEN * n_requests
    flash = load_exported_model(os.path.join(base, "1"), device="cuda")
    dense = load_exported_model(dense_dir, device="cuda")
    gaps = teacher_forced_gaps(flash, dense, ids, mask, tokens)
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    n_tokens = generated_tokens(tokens)
    print(f"generate [{card}]: T5-small (d_model {hp['d_model']}, "
          f"{hp['n_layers']} + {hp['n_layers']} layers, {hp['n_heads']} heads, "
          f"vocab {hp['vocab_size']}) bf16, beam {BEAM}, max_decode_len "
          f"{DECODE_LEN}, flash decode, 8 concurrent clients: {n_requests} "
          f"requests ({tokens.shape[0]} rows, {n_tokens} generated tokens) in "
          f"{wall_s:.2f} s; p50 {np.percentile(lat_ms, 50):.1f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.1f} ms; {n_tokens / wall_s:.1f} "
          f"generated tokens/s (the warm-up request, alone and first: "
          f"{warm[0][2] * 1e3:.1f} ms)", flush=True)
    print(f"generate: flash_decode launches {launches} = {T5_LAYERS} layers x "
          f"{DECODE_LEN} passes x {n_requests} requests expected", flush=True)
    print(f"generate: teacher-forced max |flash - dense| logit over "
          f"{DECODE_LEN} steps = {gaps['sound']:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g})", flush=True)
    controls = {name: gap for name, gap in gaps.items() if name != "sound"}
    for name, gap in controls.items():
        print(f"generate control, {name}: max |flash - dense| logit = "
              f"{gap:.3e} (must exceed tol {DECODE_LOGIT_TOL:g})", flush=True)
    decode_step_breakdown(flash, ids, mask, card)
    if launches != expected:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {expected}")
    if gaps["sound"] > DECODE_LOGIT_TOL:
        raise AssertionError("flash-decoded logits disagree with dense")
    if min(controls.values()) <= DECODE_LOGIT_TOL:
        raise AssertionError(
            "a control stays within DECODE_LOGIT_TOL: the decode check cannot "
            "tell a faulty kernel")
    del dense
    return launches, flash


N_ENGINE_SEQS = 24


def engine_phase(loaded, seed, card):
    """The continuous-batching engine over the served payload's decode
    contract: 24 sequences with ragged prompts and budgets submitted from
    threads.  Returns the flash_decode launches of that traffic."""
    rng = np.random.default_rng(seed + 4)
    vocab = loaded.model.shared.num_embeddings
    prompts = [rng.integers(4, vocab, size=int(rng.integers(8, MAX_INPUT_LEN + 1)))
               for _ in range(N_ENGINE_SEQS)]
    budgets = [int(m) for m in rng.integers(DECODE_LEN // 8, DECODE_LEN + 1,
                                            size=N_ENGINE_SEQS)]
    engine = GenerativeEngine(loaded.decode_fns, loaded.params, device="cuda",
                              max_batch_size=8, page_size=DECODE_LEN // 4)
    try:
        engine.warm()
        fa.decode_launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            streams = list(pool.map(
                lambda i: engine.submit(prompts[i], max_new_tokens=budgets[i],
                                        timeout_s=600),
                range(N_ENGINE_SEQS)))
        wall_s = time.perf_counter() - t0
        launches = fa.decode_launches
        steps, prefills = engine.steps_run, engine.prefills_run
        compiles = engine.compiles_after_warm
        occupancy = engine.live_rows_total / max(1, engine.bucket_rows_total)
        buckets = sorted(engine._buckets_run)
    finally:
        engine.close()

    ended = all(
        (len(s) == m and EOS_ID not in s[:-1])
        or (len(s) <= m and s[-1] == EOS_ID and EOS_ID not in s[:-1])
        for s, m in zip((list(x) for x in streams), budgets))
    # Isolated greedy decodes of the same prompts (padded as the engine
    # pads them), each with its own budget.
    same = 0
    with torch.inference_mode():
        for prompt, budget, stream in zip(prompts, budgets, streams):
            ids = np.zeros((1, MAX_INPUT_LEN), np.int64)
            ids[0, :len(prompt)] = prompt
            greedy = t5m.make_greedy_generate(loaded.model, max_decode_len=budget,
                                              eos_id=EOS_ID)
            toks, _ = greedy(loaded.params, torch.as_tensor(ids, device=DEVICE),
                             torch.as_tensor(ids > 0, device=DEVICE).to(torch.int32))
            same += toks[0, :len(stream)].cpu().tolist() == stream.tolist()
    n_tokens = sum(len(s) for s in streams)
    print(f"engine [{card}]: GenerativeEngine, max_batch_size 8, page_size "
          f"{engine.page_size}, "
          f"{N_ENGINE_SEQS} sequences (prompts 8..{MAX_INPUT_LEN}, budgets "
          f"{min(budgets)}..{max(budgets)}) from 8 threads: {prefills} prefills, "
          f"{steps} steps in {wall_s:.2f} s; {steps / wall_s:.1f} steps/s, "
          f"{n_tokens / wall_s:.1f} tokens/s, mean occupancy {occupancy:.3f}; "
          f"buckets run {buckets}; compiles after warm {compiles}", flush=True)
    print(f"engine: {same} of {N_ENGINE_SEQS} streams equal the isolated greedy "
          f"decode (reported only: cuBLAS may pick other kernels at another "
          f"batch size); flash_decode launches {launches} = {T5_LAYERS} x "
          f"({prefills} prefills + {steps} steps) expected", flush=True)
    if not ended:
        raise AssertionError("an engine stream did not end at EOS or its budget")
    if prefills != N_ENGINE_SEQS or launches != T5_LAYERS * (prefills + steps):
        raise AssertionError(f"engine launched flash_decode {launches} times "
                             f"for {prefills} prefills and {steps} steps")
    if compiles != 0:
        raise AssertionError(f"{compiles} engine buckets first ran after warm()")
    return launches


# The long-cache engine run: T5-small's decode contract at a 2048-key cache
# (kv buckets 256/512/1024/2048), 8 sequences with budgets past 1024
# tokens, so the decode kernel runs with up to S = 8 splits per (row, head)
# and the last bucket reads more than 1024 keys per row.  Sequence i is
# submitted once the engine has run i * LONG_STAGGER steps, so the rows'
# positions are ragged (about 48 keys apart, across a split boundary at
# the 2048 bucket).
LONG_DECODE_LEN = 2048
LONG_PAGE = 256
N_LONG_SEQS = 8
LONG_BUDGETS = (1100, 1400)
LONG_STAGGER = 48


def split_lost(q, k, v, *, kv_mask, bias=None, block_k=None):
    """Control: the kernel loses the keys of the split that holds each
    row's current position (a merge that drops a rank)."""
    b, l, h, _ = k.shape
    ranges = fa.decode_split_ranges(
        l, fa.decode_splits(b, h, l, fa.sm_count(q.device)))
    short = kv_mask.clone()
    for row, last in enumerate((short.to(torch.int32).sum(dim=1) - 1).tolist()):
        lo, hi = next(r for r in ranges if r[0] <= last < r[1])
        short[row, lo:hi] = False
    return fa.flash_decode_attention(q, k, v, kv_mask=short, bias=bias,
                                     block_k=block_k)


def dense_decode(q, k, v, *, kv_mask, bias=None, block_k=None):
    """The decoder's dense decode attention, in the kernel's place."""
    return dense_attention(q, k, v, kv_mask=kv_mask, bias=bias)


def held(inner, ratios):
    """``inner`` (the kernel or a control around it) in the kernel's place,
    each call's output held against the plain version on the decoder's own
    inputs: ``ratios`` gets each call's max |out - ref| / OUT_TOL."""
    def wrapper(q, k, v, *, kv_mask, bias=None, block_k=None):
        out = inner(q, k, v, kv_mask=kv_mask, bias=bias, block_k=block_k)
        ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=kv_mask,
                                                  bias=bias)
        ratios.append(tol_ratio(out, ref, OUT_TOL[q.dtype]))
        return out
    return wrapper


def engine_long_phase(loaded, seed, card):
    """The engine over the payload's weights at a 2048-key cache: 8
    sequences with budgets of 1100-1400 tokens from threads.  Every stream
    ends, launches = layers x (prefills + steps), the 2048 bucket runs, no
    bucket first runs after warm(); one step of the 2048 bucket whose
    deepest row is past 1024 keys (the rows at ragged positions) is
    replayed from a copy of its inputs with dense decode attention (its
    logits within DECODE_LOGIT_TOL of the kernel's), with the kernel held
    call by call against its plain version (within OUT_TOL), and under two
    controls that must miss OUT_TOL.  Returns the flash_decode launches of
    the traffic."""
    hp = loaded.spec["hyperparameters"]
    fns = t5_module.make_decode_fns(loaded.model,
                                    {**hp, "max_decode_len": LONG_DECODE_LEN})
    run_step = fns.step
    captured = {}

    def step(params, cache, tok, pos, encoded, enc_mask, klen):
        # The first traffic step of the last bucket (its deepest row is past
        # 1024 keys, or a smaller bucket would do): copy its inputs before it
        # writes this step's K/V into the arena.
        if (captured.get("armed") and "inputs" not in captured
                and klen == LONG_DECODE_LEN):
            captured["inputs"] = ({n: c.clone() for n, c in cache.items()},
                                  tok.clone(), pos.clone(), encoded.clone(),
                                  enc_mask.clone())
            new, logits = run_step(params, cache, tok, pos, encoded, enc_mask,
                                   klen)
            captured["flash"] = logits.float().clone()
            return new, logits
        return run_step(params, cache, tok, pos, encoded, enc_mask, klen)

    fns.step = step
    rng = np.random.default_rng(seed + 5)
    vocab = loaded.model.shared.num_embeddings
    prompts = [rng.integers(4, vocab, size=int(rng.integers(8, MAX_INPUT_LEN + 1)))
               for _ in range(N_LONG_SEQS)]
    budgets = [int(m) for m in rng.integers(LONG_BUDGETS[0], LONG_BUDGETS[1] + 1,
                                            size=N_LONG_SEQS)]
    engine = GenerativeEngine(fns, loaded.params, device="cuda",
                              max_batch_size=8, page_size=LONG_PAGE)
    try:
        engine.warm()
        captured["armed"] = True
        fa.decode_launches = 0
        t0 = time.perf_counter()

        def submit(i):
            while engine.steps_run < i * LONG_STAGGER:
                time.sleep(0.001)
            return engine.submit(prompts[i], max_new_tokens=budgets[i],
                                 timeout_s=600)

        with ThreadPoolExecutor(N_LONG_SEQS) as pool:
            streams = list(pool.map(submit, range(N_LONG_SEQS)))
        wall_s = time.perf_counter() - t0
        launches = fa.decode_launches
        steps, prefills = engine.steps_run, engine.prefills_run
        compiles = engine.compiles_after_warm
        occupancy = engine.live_rows_total / max(1, engine.bucket_rows_total)
        buckets = sorted(engine._buckets_run)
        kv_buckets = engine.kv_buckets
    finally:
        engine.close()

    ended = all(
        (len(s) == m and EOS_ID not in s[:-1])
        or (len(s) <= m and s[-1] == EOS_ID and EOS_ID not in s[:-1])
        for s, m in zip((list(x) for x in streams), budgets))
    n_tokens = sum(len(s) for s in streams)
    if "inputs" not in captured:
        raise AssertionError("no traffic step ran the 2048-key bucket")
    cache, tok, pos, encoded, enc_mask = captured["inputs"]
    b = tok.shape[0]

    def replay(wrapper):
        with kernel_as(wrapper), torch.inference_mode():
            _, logits = run_step(loaded.params,
                                 {n: c.clone() for n, c in cache.items()}, tok,
                                 pos, encoded, enc_mask, LONG_DECODE_LEN)
        return logits.float()

    dense = replay(dense_decode)
    sound = (captured["flash"] - dense).abs().max().item()
    ratios = {name: [] for name in ("kernel", "validity one short",
                                    "split lost")}
    replay(held(fa.flash_decode_attention, ratios["kernel"]))
    controls = {name: (replay(held(wrapper, ratios[name])) - dense)
                .abs().max().item()
                for name, wrapper in (("validity one short", validity_one_short),
                                      ("split lost", split_lost))}
    worst = {name: max(r) for name, r in ratios.items()}
    print(f"engine_long [{card}]: GenerativeEngine, max_batch_size 8, "
          f"max_decode_len {LONG_DECODE_LEN}, page_size {LONG_PAGE} (kv buckets "
          f"{kv_buckets}), {N_LONG_SEQS} sequences (budgets {min(budgets)}.."
          f"{max(budgets)}) from {N_LONG_SEQS} threads: {prefills} prefills, "
          f"{steps} steps in {wall_s:.2f} s; {steps / wall_s:.1f} steps/s, "
          f"{n_tokens / wall_s:.1f} tokens/s, mean occupancy {occupancy:.3f}; "
          f"buckets run {buckets}; compiles after warm {compiles}", flush=True)
    splits = fa.decode_splits(b, int(hp["n_heads"]), LONG_DECODE_LEN,
                              fa.sm_count("cuda"))
    print(f"engine_long: flash_decode launches {launches} = {T5_LAYERS} x "
          f"({prefills} prefills + {steps} steps) expected; splits at the "
          f"{LONG_DECODE_LEN} bucket S={splits}", flush=True)
    print(f"engine_long: replayed step at positions {pos.tolist()} (batch {b}, "
          f"kv {LONG_DECODE_LEN}): max |flash - dense| logit = {sound:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g})", flush=True)
    print(f"engine_long: replayed step, each of its {len(ratios['kernel'])} "
          f"decode calls held against the plain version: worst "
          f"{worst['kernel']:.3f} of OUT_TOL (at most 1)", flush=True)
    for name, gap in controls.items():
        must = "must exceed" if name == "split lost" else "reported"
        print(f"engine_long control, {name}: worst {worst[name]:.3f} of "
              f"OUT_TOL at the attention output (must exceed 1); max "
              f"|control - dense| logit = {gap:.3e} ({must} tol "
              f"{DECODE_LOGIT_TOL:g})", flush=True)
    if not ended:
        raise AssertionError("a long-cache stream did not end at EOS or its "
                             "budget")
    if prefills != N_LONG_SEQS or launches != T5_LAYERS * (prefills + steps):
        raise AssertionError(f"long-cache engine launched flash_decode "
                             f"{launches} times for {prefills} prefills and "
                             f"{steps} steps")
    if not any(kv == LONG_DECODE_LEN for _, kv in buckets):
        raise AssertionError(f"the {LONG_DECODE_LEN}-key bucket never ran")
    if compiles != 0:
        raise AssertionError(f"{compiles} long-cache buckets first ran after "
                             "warm()")
    if len(set(pos.tolist())) < 2:
        raise AssertionError("the replayed long-cache step has no ragged "
                             "positions")
    if worst["kernel"] > 1.0:
        raise AssertionError("the kernel disagrees with its plain version in "
                             "the replayed long-cache step")
    if sound > DECODE_LOGIT_TOL:
        raise AssertionError("long-cache flash-decoded logits disagree with "
                             "dense")
    for name in ("validity one short", "split lost"):
        if worst[name] <= 1.0:
            raise AssertionError(f"the {name} control stays within OUT_TOL: "
                                 "the long-cache check cannot tell it")
    if controls["split lost"] <= DECODE_LOGIT_TOL:
        raise AssertionError("the split-lost control stays within "
                             "DECODE_LOGIT_TOL: the long-cache check cannot "
                             "tell a faulty merge")
    return launches


# ------------------------------------------------------------------ taxi DAG

# Cut from a deployment's months of trips so that the whole script, with
# the two pipeline DAGs after this phase, stays near 330 s on an H100.
TAXI_ROWS = 500_000
TAXI_SAMPLE = os.path.join(REPO, "tests", "testdata", "taxi_sample.csv")
# Share of empty fields in the made CSV's trip_start_hour (a null int:
# NaN after the read, bucketized past the last boundary) and company (an
# empty string, a vocabulary term).  The reference preprocessing has no
# fill_missing, so an empty miles, fare or tips field would reach the model
# as NaN.
TAXI_EMPTY = 0.01
# Transform on the card vs apply_host, per output: the torch evaluator does
# the same f32 ops as numpy (+ - * / with f32 scalar operands, clamp,
# one-hot, the left-side search), so those outputs must be bit-equal.
# log1p is the card's libdevice log1pf against numpy's: at most
# TAXI_LOG1P_ULPS f32 ulps apart, and log_fare_z = (log1p(fare) - mean) /
# std carries that difference through exactly-rounded ops, so per element
# |card - host| <= TAXI_LOG1P_ULPS * ulp(log1p(fare)) / std + ulp(host).
TAXI_LOG1P_ULPS = 2
# The card's float64 analyzer states vs numpy's float64 (relative).
TAXI_STATE_RTOL = 1e-12
# The pushed payload's predictions (card vs CPU) and the Evaluator's
# metrics (card vs the same evaluation on the CPU).
TAXI_PRED_TOL = 1e-5


def taxi_csv(path, seed, rows):
    """A raw CSV with the taxi schema, ``rows`` rows made from ``seed``
    with the value ranges and category sets of tests/testdata's sample,
    with about TAXI_EMPTY empty fields in trip_start_hour and company."""
    import csv as csv_mod

    with open(TAXI_SAMPLE, newline="") as f:
        sample = list(csv_mod.DictReader(f))
    col = {k: [r[k] for r in sample] for k in sample[0]}
    rng = np.random.default_rng(seed)
    miles_hi = max(float(v) for v in col["trip_miles"])
    payments = sorted(set(col["payment_type"]))
    companies = sorted(set(col["company"]))
    miles = rng.uniform(0.1, miles_hi, rows)
    fare = 3.25 + 2.25 * miles + rng.uniform(0.0, 2.0, rows)
    hour = rng.integers(0, 24, rows)
    pay = rng.choice(payments, rows)
    tips = np.where(pay == "Cash", 0.0,
                    fare * rng.choice([0.0, 0.05, 0.15, 0.2], rows))
    text = {
        "trip_miles": np.char.mod("%.2f", miles),
        "fare": np.char.mod("%.2f", fare),
        "trip_start_hour": hour.astype("U"),
        "payment_type": pay,
        "company": rng.choice(companies, rows),
        "tips": np.char.mod("%.2f", tips),
    }
    for name in ("trip_start_hour", "company"):
        text[name] = np.where(rng.random(rows) < TAXI_EMPTY, "", text[name])
    header = list(text)
    lines = text[header[0]]
    for name in header[1:]:
        lines = np.char.add(np.char.add(lines, ","), text[name])
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        f.write("\n".join(lines.tolist()))
        f.write("\n")


def _f32_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(x).astype(np.float64)


def held_to_host(host, got, bound, what):
    """``got`` (a Transform's outputs on the card) against ``host``
    (apply_host): every output bit for bit, dtypes included, but
    log_fare_z, held per element to ``bound``; returns log_fare_z's worst
    share of its bound (None without it).  ``what`` names the phase and
    the source in the messages."""
    ratio = None
    for name in host:
        a = np.asarray(host[name], np.float64)
        b = np.asarray(got[name], np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what} {name} NaNs differ")
        diff = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
        if name == "log_fare_z":
            ratio = float(np.nanmax(diff / bound))
            if ratio > 1.0:
                raise AssertionError(f"{what} log_fare_z at "
                                     f"{ratio:.3f} of its bound")
        elif diff.max() != 0 or host[name].dtype != got[name].dtype:
            raise AssertionError(
                f"{what} {name} not bit-equal to apply_host (max "
                f"|diff| {diff.max():.3e}, dtypes {host[name].dtype}/"
                f"{got[name].dtype})")
    return ratio


def transform_checks(graph_uri, raw_uri, materialized_uri, card):
    """The Transform on the card: the first chunk of each split as the
    Transform node materialized it, and as apply_device gives it now,
    against apply_host of the same raw rows (and a shifted-mean control
    that must miss); then the card's float64 analyzer states vs numpy's."""
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.transform import graph as tg

    graph = tg.TransformGraph.load(graph_uri)
    zs = [n.id for n in graph.nodes if n.op == "z_score"]
    log1p_z = graph.outputs["log_fare_z"]
    for split in ("train", "eval"):
        # Output shard i is input shard i, chunk for chunk.
        chunk = next(examples_io.iter_column_chunks(raw_uri, split))
        materialized = next(examples_io.iter_column_chunks(
            materialized_uri, split))
        host = graph.apply_host(chunk)
        dev = graph.apply_device(chunk, "cuda")
        if graph.device_apply_active is not True:
            raise AssertionError("taxi_dag: the Transform graph did not run "
                                 "on the card")
        fare = np.asarray(chunk["fare"], np.float32)
        l_host = np.log1p(fare)
        l_dev = torch.log1p(torch.from_numpy(fare).cuda()).cpu().numpy()
        ok = ~np.isnan(l_host)
        ulps = np.abs(l_dev[ok].astype(np.float64) - l_host[ok]) / _f32_ulp(
            l_host[ok])
        if ulps.max() > TAXI_LOG1P_ULPS:
            raise AssertionError(f"taxi_dag: log1p {ulps.max()} ulps apart")
        std = float(graph.state[log1p_z]["std"])
        bound = (TAXI_LOG1P_ULPS * _f32_ulp(l_host) / std
                 + _f32_ulp(host["log_fare_z"]))
        node_ratio = held_to_host(host, materialized, bound,
                                  "taxi_dag: Transform node")
        dev_ratio = held_to_host(host, dev, bound, "taxi_dag: apply_device")
        # Control: every z-score mean shifted by one std must miss.
        shifted = tg.TransformGraph.load(graph_uri)
        for nid in zs:
            st = shifted.state[nid]
            st["mean"] = float(st["mean"]) + float(st["std"])
        ctl = shifted.apply_device(chunk, "cuda")
        ctl_ratio = float(np.nanmax(np.abs(
            np.asarray(ctl["log_fare_z"], np.float64)
            - np.asarray(host["log_fare_z"], np.float64)) / bound))
        ctl_miles = float(np.nanmax(np.abs(ctl["miles_z"] - host["miles_z"])))
        if ctl_ratio <= 1.0 or ctl_miles == 0.0:
            raise AssertionError("taxi_dag: the shifted-mean control did not "
                                 "miss the bound")
        print(f"taxi_dag transform [{card}] {split} chunk of "
              f"{len(fare)} rows: the Transform node's output and "
              f"apply_device == apply_host bit for bit on "
              f"{sorted(n for n in host if n != 'log_fare_z')}; log1p at most "
              f"{ulps.max():.0f} ulps apart, log_fare_z at {node_ratio:.3f} "
              f"(node) / {dev_ratio:.3f} of its bound; shifted-mean control "
              f"{ctl_ratio:.3e} of it (miles_z off by {ctl_miles:.3f})",
              flush=True)

    # The card's float64 analyzer states vs numpy float64 on the host.
    host_graph = tg.TransformGraph(graph.nodes, graph.outputs)
    host_graph.analyze_chunks(
        lambda: examples_io.iter_column_chunks(raw_uri, "train"), device=None)
    worst_rel = 0.0
    for nid, st in graph.state.items():
        for key, val in st.items():
            if key.startswith("_"):
                continue
            want = host_graph.state[nid][key]
            if key == "vocab":
                if list(val) != list(want):
                    raise AssertionError(f"taxi_dag: vocab #{nid} differs")
                continue
            a = np.asarray(val, np.float64)
            b = np.asarray(want, np.float64)
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
                        ) if a.size else 0.0
            worst_rel = max(worst_rel, rel)
            if a.shape != b.shape or rel > TAXI_STATE_RTOL:
                raise AssertionError(
                    f"taxi_dag: analyzer #{nid} {key} card {a} vs host {b}")
    print(f"taxi_dag analyzers [{card}]: float64 states on the card vs numpy "
          f"on the host, worst relative difference {worst_rel:.3e} (bound "
          f"{TAXI_STATE_RTOL:g})", flush=True)
    return graph


def transform_rates(graph, raw_uri, card, n_chunks=16, phase="taxi_dag"):
    """Materialization rows/s over the train split's first chunks: the
    torch evaluator on the card vs apply_host; and one profiled chunk."""
    from tpu_pipelines_torch.data import examples_io

    chunks = []
    for chunk in examples_io.iter_column_chunks(raw_uri, "train"):
        chunks.append(chunk)
        if len(chunks) == n_chunks:
            break
    n_rows = [len(next(iter(c.values()))) for c in chunks]
    rows = sum(n_rows)
    graph.apply_device(chunks[0], "cuda")
    rates = {}
    for name, fn in (("card", lambda c: graph.apply_device(c, "cuda")),
                     ("apply_host", graph.apply_host)):
        t0 = time.perf_counter()
        for c in chunks:
            fn(c)
        rates[name] = rows / (time.perf_counter() - t0)

    def step(_):
        graph.apply_device(chunks[0], "cuda")
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, 5)
    print(f"{phase} transform rate [{card}]: {rates['card']:.0f} rows/s "
          f"through the card, {rates['apply_host']:.0f} rows/s apply_host "
          f"({len(chunks)} chunks, {rows} rows); one chunk of "
          f"{n_rows[0]} rows: host wall {wall_ms:.3f} ms "
          f"({profiled_ms:.3f} ms traced), device busy {busy_ms:.4f} ms "
          f"(idle share {1 - busy_ms / profiled_ms:.3f}), {n_kernels:.0f} "
          f"kernels", flush=True)
    return rates


def taxi_dag_phase(seed, card, workdir, rows=TAXI_ROWS):
    """The Chicago-taxi DAG on the card: all nine nodes through
    LocalDagRunner(device="cuda"), cold then warm, with the Transform, the
    Trainer and the served payload checked."""
    from tpu_pipelines_torch import trainer as trainer_pkg
    from tpu_pipelines_torch.components.evaluator import evaluate_payload
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.evaluation.metrics import EvalOutcome
    from tpu_pipelines_torch.examples.taxi_pipeline import create_pipeline
    from tpu_pipelines_torch.metadata import open_store
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    base = os.path.join(workdir, "taxi")
    os.makedirs(base)
    csv_path = os.path.join(base, "taxi.csv")
    t0 = time.perf_counter()
    taxi_csv(csv_path, seed, rows)
    print(f"taxi_dag data: {rows} rows, {os.path.getsize(csv_path)} bytes of "
          f"CSV made in {time.perf_counter() - t0:.1f} s", flush=True)

    # The Trainer's run_fn calls train_loop and export_model through the
    # trainer package: record its logged losses and the device of the
    # exported params.
    seen = {"losses": [], "param_devices": set()}
    real_loop, real_export = trainer_pkg.train_loop, trainer_pkg.export_model

    def loop(**kw):
        def cb(step, metrics):
            seen["losses"] += [v for k, v in metrics.items() if "loss" in k]
        model, result = real_loop(metrics_cb=cb, **kw)
        seen["result"] = result
        return model, result

    def export(**kw):
        seen["param_devices"] |= {str(t.device) for t in kw["params"].values()}
        return real_export(**kw)

    with mock.patch.object(trainer_pkg, "train_loop", loop), \
            mock.patch.object(trainer_pkg, "export_model", export):
        t0 = time.perf_counter()
        cold = LocalDagRunner(device="cuda").run(create_pipeline(base, csv_path))
        cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = LocalDagRunner(device="cuda").run(create_pipeline(base, csv_path))
    warm_s = time.perf_counter() - t0
    statuses = {k: v.status for k, v in cold.nodes.items()}
    if len(statuses) != 9 or set(statuses.values()) != {"COMPLETE"}:
        raise AssertionError(f"taxi_dag: cold run {statuses}")
    if {v.status for v in warm.nodes.values()} != {"CACHED"}:
        raise AssertionError(
            f"taxi_dag: warm run {({k: v.status for k, v in warm.nodes.items()})}")
    print(f"taxi_dag nodes [{card}]: cold run {cold_s:.1f} s: " + ", ".join(
        f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
        + f"; warm run {warm_s:.2f} s, all 9 CACHED", flush=True)

    store = open_store(os.path.join(base, "metadata.sqlite"))
    try:
        props = {
            n: [e for e in store.get_executions(node_id=n)
                if e.state.value == "COMPLETE"][-1].properties
            for n in statuses
        }
    finally:
        store.close()
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    if not props["Evaluator"]["blessed"] or not props["InfraValidator"]["blessed"]:
        raise AssertionError(f"taxi_dag: not blessed: {props['Evaluator']}")
    if not props["Pusher"]["pushed"]:
        raise AssertionError(f"taxi_dag: not pushed: {props['Pusher']}")
    tprops = props["Transform"]
    if not tprops["materialize_on_device"] or tprops["device"] != "cuda":
        raise AssertionError(f"taxi_dag: Transform ran {tprops}")

    # Trainer: finite losses, params on the card, no capture after warm-up.
    result = seen["result"]
    losses = seen["losses"] + [props["Trainer"]["final_loss"],
                               props["Trainer"]["final_eval_loss"]]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"taxi_dag: losses {losses}")
    if seen["param_devices"] != {"cuda:0"}:
        raise AssertionError(f"taxi_dag: exported params on "
                             f"{seen['param_devices']}")
    if result.compiles_after_warm != 0:
        raise AssertionError(f"taxi_dag: {result.compiles_after_warm} "
                             "captures after warm-up")
    print(f"taxi_dag trainer [{card}]: {result.steps_completed} steps at "
          f"batch 32, {result.examples_per_sec:.1f} examples/s, "
          f"{len(losses)} logged losses finite (last {losses[-3]:.4f}), "
          f"eval accuracy {props['Trainer']['final_eval_accuracy']:.4f}, "
          f"compiles after warm-up 0, exported params on cuda:0", flush=True)

    raw_uri = out["CsvExampleGen"]["examples"]
    graph = transform_checks(out["Transform"]["transform_graph"], raw_uri,
                             out["Transform"]["transformed_examples"], card)
    transform_rates(graph, raw_uri, card)

    # Served payload: the pushed version on the card vs on the CPU.
    pushed = props["Pusher"]["destination"]
    raw = next(examples_io.iter_column_chunks(raw_uri, "eval", rows=4096))
    on_card = load_exported_model(pushed, device="cuda").predict(raw)
    on_cpu = load_exported_model(pushed, device="cpu").predict(raw)
    gap = float(np.max(np.abs(on_card - on_cpu)))
    if on_card.shape != (len(raw["fare"]),) or gap > TAXI_PRED_TOL:
        raise AssertionError(f"taxi_dag: served predictions card vs CPU {gap}")

    # Evaluator: its metrics from the card vs the same evaluation on the CPU.
    model_uri = out["Trainer"]["model"]
    examples_uri = out["Transform"]["transformed_examples"]
    eval_props = {"label_key": "label_big_tip", "eval_split": "eval",
                  "batch_size": 512, "slice_columns": ["hour_bucket"],
                  "problem": "binary_classification"}
    card_metrics = EvalOutcome.load(out["Evaluator"]["evaluation"]).overall()
    n_eval = card_metrics.num_examples
    t0 = time.perf_counter()
    evaluate_payload(model_uri, examples_uri, eval_props, "cuda")
    eval_s = time.perf_counter() - t0
    cpu_metrics = evaluate_payload(model_uri, examples_uri, eval_props,
                                   "cpu").overall()
    metric_gap = max(abs(card_metrics.metrics[k] - cpu_metrics.metrics[k])
                     for k in card_metrics.metrics)
    if metric_gap > TAXI_PRED_TOL or cpu_metrics.num_examples != n_eval:
        raise AssertionError(f"taxi_dag: Evaluator card {card_metrics} vs "
                             f"CPU {cpu_metrics}")
    print(f"taxi_dag served [{card}]: pushed payload predicts {len(on_card)} "
          f"raw rows on the card within {gap:.3e} of the CPU (bound "
          f"{TAXI_PRED_TOL:g}); Evaluator accuracy "
          f"{card_metrics.metrics['accuracy']:.4f}, auc "
          f"{card_metrics.metrics['auc']:.4f} on {n_eval} examples, within "
          f"{metric_gap:.3e} of the CPU; evaluation {n_eval / eval_s:.0f} "
          f"examples/s on the card", flush=True)


# ------------------------------------------------------------------ BERT DAG

BERT_DAG_ROWS = 40_000
BERT_DAG_STEPS = 100
BERT_LEXICON = 3000
# Label-bearing words per review, drawn from its label's 20 words.
BERT_CUES = 3


def counters():
    return {name: getattr(fa, name) for name in fa.COUNTERS}


def zero_counters():
    for name in fa.COUNTERS:
        setattr(fa, name, 0)


def by_record(counts):
    """Launch counters under the kernels' record names."""
    return {"flash_fwd": counts["launches"],
            "flash_bwd_dvec": counts["dvec_launches"],
            "flash_bwd_dq": counts["dq_launches"],
            "flash_bwd_dkv": counts["dkv_launches"],
            "flash_decode": counts["decode_launches"]}


def made_up_words(rng, n):
    """``n`` distinct made-up words of 2-4 syllables, in a seeded order."""
    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    words = set()
    while len(words) < n:
        words.add("".join(rng.choice(syllables, int(rng.integers(2, 5)))))
    return list(rng.permutation(sorted(words)))


def quoted_text(i, text, lead):
    """Every tenth field holds a comma and every thirteenth doubled quotes
    after ``lead``, so the CSV's quoted fields are parsed, not split."""
    if i % 10 == 0:
        text = text.replace(" ", ", ", 1)
    if i % 13 == 0:
        text = f'{lead} ""{text}""'
    return f'"{text}"'


def reviews_csv(path, seed, rows):
    """``text,label`` reviews made from ``seed``: 8-60 words from a made-up
    lexicon of BERT_LEXICON words, BERT_CUES of them from the label's own 20
    words (a real review corpus is not on the machine)."""
    rng = np.random.default_rng(seed)
    lexicon = made_up_words(rng, BERT_LEXICON)
    cues = (np.asarray(lexicon[:20]), np.asarray(lexicon[20:40]))
    filler = np.asarray(lexicon[40:])
    labels = rng.integers(0, 2, rows)
    lengths = rng.integers(8, 61, rows)
    lines = ["text,label"]
    for i in range(rows):
        words = rng.choice(filler, lengths[i])
        at = rng.choice(lengths[i], BERT_CUES, replace=False)
        words[at] = rng.choice(cues[labels[i]], BERT_CUES)
        lines.append(f"{quoted_text(i, ' '.join(words), 'she wrote')},"
                     f"{labels[i]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def payload_view(uri, dst, **hparams):
    """A view of the payload at ``uri`` with ``hparams`` in its spec: its
    files linked, its spec rewritten."""
    os.makedirs(dst)
    for name in os.listdir(uri):
        if name != "model_spec.json":
            os.symlink(os.path.join(uri, name), os.path.join(dst, name))
    with open(os.path.join(uri, "model_spec.json")) as f:
        spec = json.load(f)
    spec["hyperparameters"].update(hparams)
    with open(os.path.join(dst, "model_spec.json"), "w") as f:
        json.dump(spec, f)
    return dst


def run_dag(name, create_pipeline, env, base, hparams, module_path):
    """The pipeline from ``create_pipeline(base)`` under ``env``, its
    Trainer's hyperparameters set to ``hparams``, through
    LocalDagRunner on the card, cold then warm.  The kernels' counters
    are set to 0 just before the cold run and read just after it; the warm
    run must launch nothing.  Returns (cold, cold seconds, warm seconds,
    launches, seen: the Trainer's result, logged losses,
    checkpoint seconds, the counters when train_loop returned, CUDA graph
    captures and replays)."""
    import importlib

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_module

    def pipeline():
        with mock.patch.dict(os.environ, env):
            pipe = create_pipeline(base)
        trainer = next(c for c in pipe.components if c.id == "Trainer")
        trainer.exec_properties["hyperparameters"] = hparams
        return pipe

    user = load_module(module_path)
    loop_module = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")
    seen = {"losses": [], "checkpoint_s": [], "captures": 0, "replays": 0}
    real_loop, real_save = user.train_loop, loop_module._save_checkpoint
    graph = torch.cuda.CUDAGraph
    real_replay, real_capture = graph.replay, graph.capture_begin

    def loop(**kw):
        def cb(step, metrics):
            seen["losses"] += [v for k, v in metrics.items() if "loss" in k]
        model, result = real_loop(metrics_cb=cb, **kw)
        seen["result"], seen["after_trainer"] = result, counters()
        return model, result

    def save(*args, **kw):
        t0 = time.perf_counter()
        real_save(*args, **kw)
        seen["checkpoint_s"].append(time.perf_counter() - t0)

    def counted(key, method):
        def wrapper(self, *args, **kwargs):
            seen[key] += 1
            return method(self, *args, **kwargs)
        return wrapper

    os.makedirs(base)
    with mock.patch.object(user, "train_loop", loop), \
            mock.patch.object(loop_module, "_save_checkpoint", save), \
            mock.patch.object(graph, "replay", counted("replays", real_replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", real_capture)):
        zero_counters()
        t0 = time.perf_counter()
        cold = LocalDagRunner(device=DEVICE).run(pipeline())
        cold_s = time.perf_counter() - t0
        launches = counters()
    t0 = time.perf_counter()
    warm = LocalDagRunner(device=DEVICE).run(pipeline())
    warm_s = time.perf_counter() - t0
    statuses = {k: v.status for k, v in cold.nodes.items()}
    if set(statuses.values()) != {"COMPLETE"}:
        raise AssertionError(f"{name}: cold run {statuses} "
                             + str({k: v.error[-2000:] for k, v in
                                    cold.nodes.items() if v.error}))
    if {v.status for v in warm.nodes.values()} != {"CACHED"}:
        raise AssertionError(
            f"{name}: warm run {({k: v.status for k, v in warm.nodes.items()})}")
    if counters() != launches:
        raise AssertionError(f"{name}: the warm run launched a kernel")
    return cold, cold_s, warm_s, launches, seen


def node_props(base, nodes):
    from tpu_pipelines_torch.metadata import open_store

    store = open_store(os.path.join(base, "metadata.sqlite"))
    try:
        return {n: [e for e in store.get_executions(node_id=n)
                    if e.state.value == "COMPLETE"][-1].properties
                for n in nodes}
    finally:
        store.close()


def trainer_checks(name, seen, steps):
    """The Trainer ran ``steps`` steps with finite losses, its first step
    eager, one capture and a replay for every later step, and no capture
    after warm-up."""
    result = seen["result"]
    if result.steps_completed != steps:
        raise AssertionError(f"{name}: {result.steps_completed} steps")
    if not seen["losses"] or not np.isfinite(seen["losses"]).all():
        raise AssertionError(f"{name}: losses {seen['losses']}")
    if (result.compiles_after_warm, seen["captures"], seen["replays"]) != (
            0, 1, steps - 1):
        raise AssertionError(
            f"{name}: {result.compiles_after_warm} compiles after warm-up, "
            f"{seen['captures']} captures, {seen['replays']} replays")


def bert_dag_phase(seed, card, workdir):
    """The BERT-base fine-tune DAG on the card (the north-star workload as
    its users run it): all six nodes through LocalDagRunner(device="cuda")
    at BERT_BASE with flash attention, cold then warm.  Returns each
    kernel's launches in the cold run."""
    from tpu_pipelines_torch.components.evaluator import evaluate_payload
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig
    from tpu_pipelines_torch.evaluation.metrics import EvalOutcome
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.transform.graph import TransformGraph

    base = os.path.join(workdir, "bert")
    csv_path = os.path.join(workdir, "reviews.csv")
    t0 = time.perf_counter()
    reviews_csv(csv_path, seed, BERT_DAG_ROWS)
    print(f"bert_dag data: {BERT_DAG_ROWS} reviews, "
          f"{os.path.getsize(csv_path)} bytes of CSV made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hp = {**bert_pipeline.BERT_BASE, "attn_impl": "flash"}
    cold, cold_s, warm_s, launches, seen = run_dag(
        "bert_dag", bert_pipeline.create_pipeline,
        {"BERT_DATA_CSV": csv_path, "BERT_TRAIN_STEPS": str(BERT_DAG_STEPS),
         "BERT_TINY": ""}, base, hp,
        os.path.join(bert_pipeline.HERE, "bert_module.py"))
    print(f"bert_dag nodes [{card}]: cold run {cold_s:.1f} s: " + ", ".join(
        f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
        + f"; warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no "
        "kernel launched", flush=True)
    props = node_props(base, cold.nodes)
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    raw_uri = out["CsvExampleGen"]["examples"]
    examples_uri = out["Transform"]["transformed_examples"]
    model_uri = out["Trainer"]["model"]
    tprops = props["Transform"]
    if not tprops["materialize_on_device"] or tprops["device"] != DEVICE:
        raise AssertionError(f"bert_dag: Transform ran {tprops}")

    # Launches from inside the runner: each step's four kernels (counted at
    # replay), the Trainer's end-of-run eval (whole batches) and the
    # Evaluator (every row) forward only.
    trainer_checks("bert_dag", seen, BERT_DAG_STEPS)
    n_eval = examples_io.num_rows(examples_uri, "eval")
    batch = hp["batch_size"]
    layers = DEFAULT_HPARAMS["n_layers"]
    steps = layers * BERT_DAG_STEPS
    trainer_fwd = steps + layers * (n_eval // batch)
    want = {"launches": trainer_fwd + layers * -(-n_eval // batch),
            "dvec_launches": steps, "dq_launches": steps,
            "dkv_launches": steps, "decode_launches": 0}
    want_trainer = {**want, "launches": trainer_fwd}
    if launches != want or seen["after_trainer"] != want_trainer:
        raise AssertionError(
            f"bert_dag: launches {launches} (after the Trainer "
            f"{seen['after_trainer']}), expected {want} ({want_trainer})")
    result = seen["result"]
    tr = props["Trainer"]
    print(f"bert_dag launches: {launches} = {layers} layers x "
          f"({BERT_DAG_STEPS} steps + {n_eval // batch} Trainer eval batches "
          f"+ {-(-n_eval // batch)} Evaluator batches) forwards and {layers} "
          f"x {BERT_DAG_STEPS} of each backward kernel; the Trainer's step 1 "
          f"eager, {seen['captures']} capture, {seen['replays']} replays, "
          f"compiles after warm-up {result.compiles_after_warm}", flush=True)
    ckpt = seen["checkpoint_s"]
    print(f"bert_dag trainer [{card}]: {result.steps_completed} steps at batch "
          f"{batch} x {PIPELINE_LEN}, {result.examples_per_sec:.1f} "
          f"examples/s, losses "
          f"{seen['losses'][0]:.4f} -> {seen['losses'][-1]:.4f} "
          f"({len(seen['losses'])} logged, finite), Trainer eval accuracy "
          f"{tr['final_eval_accuracy']:.4f}; {len(ckpt)} checkpoints "
          f"{', '.join(f'{x:.2f}' for x in ckpt)} s", flush=True)

    # The Transform on the card: the first chunk of each split as the node
    # materialized it and as apply_device gives it now, bit for bit equal
    # to apply_host.
    graph = TransformGraph.load(out["Transform"]["transform_graph"])
    truncated = 0
    for split in ("train", "eval"):
        chunk = next(examples_io.iter_column_chunks(raw_uri, split))
        materialized = next(examples_io.iter_column_chunks(examples_uri, split))
        host = graph.apply_host(chunk)
        dev = graph.apply_device(chunk, DEVICE)
        if graph.device_apply_active is not True:
            raise AssertionError("bert_dag: the Transform graph did not run "
                                 "on the card")
        held_to_host(host, materialized, None, "bert_dag: Transform node")
        held_to_host(host, dev, None, "bert_dag: apply_device")
        truncated += int((host["input_ids"][:, -1] != 0).sum())
        print(f"bert_dag transform [{card}] {split} chunk of "
              f"{len(chunk['text'])} rows: the Transform node's output and "
              f"apply_device == apply_host bit for bit on {sorted(host)}",
              flush=True)
    vocab = graph.tokenizer_vocab_sizes()["input_ids"]
    if not truncated or abs(vocab - BERT_LEXICON) > 64:
        raise AssertionError(f"bert_dag: vocab {vocab}, {truncated} rows "
                             "truncated")
    rates = transform_rates(graph, raw_uri, card, n_chunks=4, phase="bert_dag")
    print(f"bert_dag tokenize: learned vocabulary {vocab} (model vocab "
          f"{-(-vocab // 64) * 64}), {truncated} rows of the first chunks "
          f"truncated at {PIPELINE_LEN}; {rates['apply_host']:.0f} rows/s "
          "through apply_host", flush=True)

    # The payload: raw rows through its embedded graph == the materialized
    # rows, bit for bit.
    flash = load_exported_model(model_uri, device=DEVICE)
    raw = next(examples_io.iter_column_chunks(raw_uri, "eval", rows=batch))
    rows = next(examples_io.iter_column_chunks(examples_uri, "eval", rows=batch))
    from_raw = flash.predict(raw)
    if not np.array_equal(from_raw, flash.predict_transformed(rows)):
        raise AssertionError("bert_dag: predict(raw) != predict_transformed")

    # The Evaluator's metrics and logits against the same payload with dense
    # attention on the first two eval batches: logits within LOGIT_TOL, the
    # loss within 2 x LOGIT_TOL (cross-entropy moves by at most twice the
    # largest logit change), accuracy only by rows whose dense margin is
    # under 2 x LOGIT_TOL; the flash payload fed each row's mask shifted by
    # one key must miss LOGIT_TOL.
    dense_uri = payload_view(model_uri, os.path.join(workdir, "dense"),
                             attn_impl="dense")
    dense = load_exported_model(dense_uri, device=DEVICE)
    eval_props = {"label_key": "label", "eval_split": "eval",
                  "batch_size": batch, "slice_columns": None,
                  "problem": "multiclass", "max_eval_examples": 2 * batch}
    metrics = {name: evaluate_payload(uri, examples_uri, eval_props,
                                      DEVICE).overall().metrics
               for name, uri in (("flash", model_uri), ("dense", dense_uri))}
    gap = control = 0.0
    margins = []
    for i, b in enumerate(BatchIterator(examples_uri, "eval", InputConfig(
            batch_size=batch, shuffle=False, num_epochs=1,
            drop_remainder=False))):
        if i == 2:
            break
        want_logits = dense.predict_transformed(b)
        gap = max(gap, float(np.abs(flash.predict_transformed(b)
                                    - want_logits).max()))
        shifted = {**b, "attention_mask": np.roll(b["attention_mask"], 1, 1)}
        control = max(control, float(np.abs(flash.predict_transformed(shifted)
                                            - want_logits).max()))
        margins.append(np.abs(want_logits[:, 1] - want_logits[:, 0]))
    margins = np.concatenate(margins)
    near = int((margins < 2 * LOGIT_TOL).sum())
    loss_gap = abs(metrics["flash"]["loss"] - metrics["dense"]["loss"])
    acc_rows = abs(metrics["flash"]["accuracy"]
                   - metrics["dense"]["accuracy"]) * len(margins)
    print(f"bert_dag evaluator vs dense attention, first {len(margins)} eval "
          f"rows: max |logit gap| {gap:.3e} (tol {LOGIT_TOL:g}); loss "
          f"{metrics['flash']['loss']:.6f} vs {metrics['dense']['loss']:.6f} "
          f"(gap {loss_gap:.3e}, bound {2 * LOGIT_TOL:g}), accuracy "
          f"{metrics['flash']['accuracy']:.4f} vs "
          f"{metrics['dense']['accuracy']:.4f} ({acc_rows:.0f} rows apart, "
          f"{near} within the margin); shifted-mask control {control:.3e} "
          f"(must exceed {LOGIT_TOL:g})", flush=True)
    if gap > LOGIT_TOL or loss_gap > 2 * LOGIT_TOL or round(acc_rows) > near:
        raise AssertionError("bert_dag: the Evaluator with flash attention "
                             "disagrees with dense attention")
    if control <= LOGIT_TOL:
        raise AssertionError("bert_dag: the shifted-mask control stays within "
                             "LOGIT_TOL")
    del dense

    # The Evaluator node's metrics == the same evaluation now; its rate.
    node = EvalOutcome.load(out["Evaluator"]["evaluation"]).overall()
    full_props = {**eval_props, "max_eval_examples": 0}
    t0 = time.perf_counter()
    again = evaluate_payload(model_uri, examples_uri, full_props, DEVICE).overall()
    eval_s = time.perf_counter() - t0
    if node.num_examples != n_eval or node.metrics != again.metrics:
        raise AssertionError(f"bert_dag: Evaluator {node} vs now {again}")

    # A replayed step at the DAG's shape, profiled.
    hp_payload = flash.spec["hyperparameters"]
    del flash
    train_batch = next(examples_io.iter_column_chunks(examples_uri, "train",
                                                      rows=batch))
    wall_ms, profiled_ms, busy_ms, n_kernels = replay_step_breakdown(
        hp_payload, seed, train_batch)
    print(f"bert_dag evaluator [{card}]: accuracy "
          f"{node.metrics['accuracy']:.4f}, loss {node.metrics['loss']:.4f} on "
          f"{n_eval} eval rows, equal to the same evaluation now; "
          f"{n_eval / eval_s:.0f} examples/s (load included); a replayed "
          f"training step at batch {batch} x {PIPELINE_LEN}: host wall "
          f"{wall_ms:.3f} ms ({profiled_ms:.3f} ms traced), device busy "
          f"{busy_ms:.3f} ms (idle share {1 - busy_ms / profiled_ms:.3f}), "
          f"{n_kernels:.0f} kernels", flush=True)
    return by_record(launches)


# ------------------------------------------------------------------ T5 DAG

T5_DAG_PAIRS = 3072
T5_DAG_STEPS = 100
T5_LEXICON = 1500


def pairs_csv(path, seed, rows):
    """``source,target`` pairs made from ``seed``: sources of 4-60 words
    from a made-up lexicon, the target the first 1-20 of them through a
    fixed word-for-word dictionary into a second made-up lexicon."""
    rng = np.random.default_rng(seed)
    words = made_up_words(rng, 2 * T5_LEXICON)
    source_words = np.asarray(words[:T5_LEXICON])
    target_of = dict(zip(words[:T5_LEXICON], words[T5_LEXICON:]))
    lengths = rng.integers(4, 61, rows)
    lines = ["source,target"]
    for i in range(rows):
        source = rng.choice(source_words, lengths[i])
        target = " ".join(target_of[w] for w in source[:20])
        lines.append(f"{quoted_text(i, ' '.join(source), 'translate')},"
                     f'"{target}"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def t5_dag_phase(seed, card, workdir):
    """The T5-small seq2seq DAG on the card: all six nodes through
    LocalDagRunner(device="cuda") at T5_SMALL with flash decode attention,
    cold then warm; the BulkInferrer beam-decodes the raw eval split
    through the payload's embedded transform.  Returns each kernel's
    launches in the cold run."""
    from tpu_pipelines_torch.components.bulk_inferrer import _shard_batches
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.examples import t5_pipeline
    from tpu_pipelines_torch.trainer.export import model_input_columns

    base = os.path.join(workdir, "t5")
    csv_path = os.path.join(workdir, "pairs.csv")
    pairs_csv(csv_path, seed, T5_DAG_PAIRS)
    hp = {**t5_pipeline.T5_SMALL, "attn_impl": "flash"}
    module_path = os.path.join(t5_pipeline.HERE, "t5_module.py")
    cold, cold_s, warm_s, launches, seen = run_dag(
        "t5_dag", t5_pipeline.create_pipeline,
        {"T5_DATA_CSV": csv_path, "T5_TRAIN_STEPS": str(T5_DAG_STEPS),
         "T5_TINY": ""}, base, hp, module_path)
    print(f"t5_dag nodes [{card}]: {T5_DAG_PAIRS} pairs; cold run "
          f"{cold_s:.1f} s: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
          + f"; warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no "
          "kernel launched", flush=True)
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    raw_uri = out["CsvExampleGen"]["examples"]
    examples_uri = out["Transform"]["transformed_examples"]
    model_uri = out["Trainer"]["model"]

    # Training is dense (T5's self-attention carries a relative bias): no
    # kernel moves until the BulkInferrer, whose beam search launches the
    # decode kernel once per decoder layer and pass, max_decode_len passes
    # a batch (the step-0 pass, then max_decode_len - 1 beam steps).
    trainer_checks("t5_dag", seen, T5_DAG_STEPS)
    if any(seen["after_trainer"].values()):
        raise AssertionError(f"t5_dag: the Trainer launched {seen['after_trainer']}")
    decode_len, batch = hp["max_decode_len"], 64
    shard_rows = examples_io.shard_row_counts(raw_uri, "eval")
    n_batches = sum(-(-r // batch) for r in shard_rows)
    layers = t5m.DEFAULT_HPARAMS["n_layers"]
    want = {**dict.fromkeys(fa.COUNTERS, 0),
            "decode_launches": layers * decode_len * n_batches}
    if launches != want:
        raise AssertionError(f"t5_dag: launches {launches}, expected {want}")
    result = seen["result"]
    print(f"t5_dag trainer [{card}]: {result.steps_completed} steps at batch "
          f"{hp['batch_size']}, {result.examples_per_sec:.1f} examples/s, "
          f"losses {seen['losses'][0]:.4f} -> {seen['losses'][-1]:.4f} "
          f"(finite), step 1 eager, {seen['captures']} capture, "
          f"{seen['replays']} replays, compiles after warm-up 0, no attention "
          f"kernel; {len(seen['checkpoint_s'])} checkpoints "
          f"{sum(seen['checkpoint_s']):.2f} s", flush=True)

    # One prediction row per eval row, in the input's order: the first
    # batch of the first shard and the last batch of the last, decoded
    # again here from the raw rows, and from the Transform's materialized
    # rows with the payload's generate step alone.
    rows = sum(shard_rows)
    preds = examples_io.read_split(out["BulkInferrer"]["inference_result"],
                                   "eval")["prediction"]
    if preds.shape != (rows, decode_len) or preds.dtype.kind != "i":
        raise AssertionError(f"t5_dag: predictions {preds.shape} {preds.dtype}")
    loaded = load_exported_model(model_uri, device=DEVICE)
    step = t5_module.make_generate_step(loaded.model,
                                        loaded.spec["hyperparameters"])
    columns = model_input_columns(loaded, raw=True)
    last = max(i for i, r in enumerate(shard_rows) if r)
    first_tokens = None
    for shard, where in ((0, "first"), (last, "last")):
        raw = list(_shard_batches(raw_uri, "eval", shard, batch, columns))
        mat = list(_shard_batches(examples_uri, "eval", shard, batch, None))
        raw, mat = (raw[0], mat[0]) if where == "first" else (raw[-1], mat[-1])
        tokens = loaded.generate(raw)
        with torch.inference_mode():
            from_rows = step(loaded.params, mat).cpu().numpy()
        n = len(tokens)
        at = 0 if where == "first" else rows - n
        if not (np.array_equal(tokens, from_rows)
                and np.array_equal(tokens, preds[at:at + n])):
            raise AssertionError(f"t5_dag: the {where} batch differs")
        if where == "first":
            first_tokens, first_rows = tokens, mat
    print(f"t5_dag bulk inference [{card}]: {rows} eval rows in {n_batches} "
          f"batches of up to {batch} x beam {hp['beam_size']}, predictions "
          f"[{rows}, {decode_len}] int; the first and the last batch decoded "
          f"again from raw rows == from the materialized rows == the node's "
          f"rows; flash_decode launches {launches['decode_launches']} = "
          f"{layers} layers x {decode_len} passes x {n_batches} batches; "
          f"{rows / cold.nodes['BulkInferrer'].wall_clock_s:.1f} rows/s, "
          f"{generated_tokens(preds) / cold.nodes['BulkInferrer'].wall_clock_s:.1f}"
          f" generated tokens/s (node wall)", flush=True)

    # Teacher-forced logits of the first batch's emitted tokens: the
    # kernel against dense decode attention, and the two controls.
    dense = load_exported_model(
        payload_view(model_uri, os.path.join(workdir, "t5_dense"),
                     attn_impl="dense"), device=DEVICE)
    gaps = teacher_forced_gaps(loaded, dense, first_rows["inputs"],
                               first_rows["input_mask"].astype(np.int32),
                               first_tokens, decode_len=decode_len)
    controls = {name: g for name, g in gaps.items() if name != "sound"}
    print(f"t5_dag teacher-forced max |flash - dense| logit over {decode_len} "
          f"steps, {len(first_tokens)} rows = {gaps['sound']:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g}); controls " + ", ".join(
              f"{name} {g:.3e}" for name, g in controls.items())
          + f" (each must exceed {DECODE_LOGIT_TOL:g})", flush=True)
    if gaps["sound"] > DECODE_LOGIT_TOL:
        raise AssertionError("t5_dag: flash-decoded logits disagree with dense")
    if min(controls.values()) <= DECODE_LOGIT_TOL:
        raise AssertionError("t5_dag: a control stays within DECODE_LOGIT_TOL")
    return by_record(launches)


def build_kernels():
    """Build every CUDA source, one nvcc each, all started together."""
    seconds, errors = {}, {}

    def build(name):
        try:
            seconds[name] = _build.build(name)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=build, args=(name,))
               for name in ("flash_attention", "flash_attention_bwd",
                            "flash_decode")]
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
    parser.add_argument("--generate-requests", type=int, default=16)
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

    clock = [time.perf_counter()]
    started = clock[0]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    build_kernels()
    phase_done("build")
    gen = torch.Generator().manual_seed(args.seed)
    fwd = kernel_phase(gen)
    bwd = bwd_kernel_phase(gen)
    decode = decode_kernel_phase(gen)
    phase_done("kernels")

    with tempfile.TemporaryDirectory() as workdir:
        served = serving_phase(args.seed, args.requests, card, workdir)
        phase_done("serving")
        generated, t5_payload = generate_phase(args.seed, args.generate_requests,
                                               card, workdir)
        phase_done("generate")
    engine = engine_phase(t5_payload, args.seed, card)
    phase_done("engine")
    engine_long = engine_long_phase(t5_payload, args.seed, card)
    del t5_payload
    phase_done("engine_long")
    trained = training_phase(args.seed, args.train_steps, card)
    phase_done("training")
    # The taxi DAG launches none of the attention kernels (its Transform
    # and model are plain torch): the counters stay where training left
    # them, and the phase checks so.
    before = counters()
    with tempfile.TemporaryDirectory() as workdir:
        taxi_dag_phase(args.seed, card, workdir)
    if counters() != before:
        raise AssertionError("taxi_dag: an attention kernel launched")
    phase_done("taxi_dag")
    with tempfile.TemporaryDirectory() as workdir:
        bert_dag = bert_dag_phase(args.seed, card, workdir)
    phase_done("bert_dag")
    with tempfile.TemporaryDirectory() as workdir:
        t5_dag = t5_dag_phase(args.seed, card, workdir)
    phase_done("t5_dag")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s",
          flush=True)
    # launches: each kernel's count in its own paths' runs: training for the
    # four flash-attention kernels (Dvec's count on the dq record), :generate
    # plus both engine runs for flash_decode; launches_by_path adds the
    # serving path's flash_fwd count and each kernel's count in the two
    # pipeline DAGs, each read from inside the runner.
    fwd["launches_by_path"] = {"serving": served,
                               "training": trained["flash_fwd"]}
    decode["launches_by_path"] = {"serving": generated, "engine": engine,
                                  "engine_long": engine_long}
    for record in bwd:
        record["launches_by_path"] = {"training": trained[record["name"]]}
    bwd[0]["dvec_launches_by_path"] = {"training": trained["flash_bwd_dvec"]}
    for path, counts in (("bert_dag", bert_dag), ("t5_dag", t5_dag)):
        for record in (fwd, *bwd, decode):
            record["launches_by_path"][path] = counts[record["name"]]
        bwd[0]["dvec_launches_by_path"][path] = counts["flash_bwd_dvec"]
    trained["flash_decode"] = generated + engine + engine_long
    records = [fwd, *bwd, decode]
    bwd[0]["dvec_launches"] = trained["flash_bwd_dvec"]
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
