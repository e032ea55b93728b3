#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases (any failure raises and the script exits non-zero):

  1. setup — print the card and its power limit, turn TF32 off, build the
     CUDA kernel from ``tpu_pipelines_torch/csrc`` and print the build
     time;
  2. kernels — hold each kernel against its plain PyTorch version on the
     card at the serving path's shapes and at edge cases (ragged length,
     causal, an all-masked batch row, f32, strided inputs), and time it
     beside its plain version, the one-call PyTorch yardstick and its
     bound at the serving shape;
  3. serving — export a BERT-base payload (full width, random weights from
     ``--seed``) with flash attention, serve it with ``ModelServer`` on the
     card with micro-batching, send concurrent REST ``:predict`` requests,
     and check every reply against the same weights served with dense
     attention (and that a wrong key mask would fail that check), and that
     every device batch launched the flash kernel once per layer.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 2 before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.models.bert import (
    DEFAULT_HPARAMS,
    build_bert_model,
    init_bert_weights,
)
from tpu_pipelines_torch.ops import _build
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

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


def kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided):
    dev = "cuda"
    if strided:  # q, k, v as slices of one packed [b, l, 3, h, d] tensor
        qkv = torch.randn(b, l, 3, h, d, generator=gen).to(dev, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (torch.randn(b, l, h, d, generator=gen).to(dev, dtype)
                   for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if mask_kind == "empty_row":
        mask[1] = 0
    return q, k, v, mask.to(dev)


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=128)
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

    seconds = _build.build("flash_attention")
    print(f"build: flash_attention.cu in {seconds:.1f} s (0.0: already "
          "built)", flush=True)

    gen = torch.Generator().manual_seed(args.seed)
    record = kernel_phase(gen)

    with tempfile.TemporaryDirectory() as workdir:
        record["launches"] = serving_phase(args.seed, args.requests, card, workdir)
    record["max_err"] = record["max_abs_err"]
    record["card"] = card
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
