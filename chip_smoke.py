#!/usr/bin/env python3
"""Smoke run of the PyTorch port (newsrecommendation_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels, holds each against its plain PyTorch
version, serves NRMS at its published width over HTTP, then trains it at
its published width.

    python3 chip_smoke.py        # from the repo root, on a machine with
                                 # one CUDA card and nvcc

Phases, each printing one line with its elapsed seconds:
  device   nvidia-smi name and power limit; TF32 off for matmuls and convs
  build    one nvcc per kernel source (csrc/qkv_fwd.cu, csrc/qkv_bwd_probs.cu)
           for sm_90a, all started together (skipped if built)
  kernel   row 1 (the forward without probs), both variants vs the plain
           version, f32 and bf16, at the shapes the serving path gives it,
           with the count of elements that differ at all; controls with a
           planted fault (bias dropped, inputs scaled, mask dropped) that
           the comparison must reject; kernel / plain /
           scaled_dot_product_attention times and the memory/flop bound
  kernel-train  rows 2 (the forward that writes probs) and 3 (the backward
           from probs) vs their plain versions, f32 and bf16, at the
           training path's shapes (news encoder 7040 x 20, user encoder
           128 x 50, masked 128 x 50 with fully masked rows): row 2's
           context bit-equal to row 1's, its probs, row 3's dqkv; controls
           (probs transposed per head, ds without its row-sum term, and in
           bf16 dv from the unrounded a); kernel / plain times and bounds
  corpus   a 65,536-news synthetic corpus, full-width NRMS params from a
           seed, and its behaviors prepared into training samples
  serve    Recommender.from_state on cuda, the HTTP server on a free
           localhost port, /score (C up to 300) and /recommend (k=10)
           requests, once with user_log_mask False and once True; served
           scores checked against the same params run on the CPU through
           the plain versions; launch counts read around both runs
  train-check  one f32 train step (dropout off, B=16, full width) on the
           card and on the CPU from the same params and batch, for
           user_log_mask False and True: loss, every leaf's gradient, the
           frozen table unchanged
  train    fit() at the headline training step (bf16 over f32 params,
           B=128, 1+4 candidates, 50-news history, dropout 0.2, Adam lr
           3e-4, frozen table, device gather, prefetch depth 2) for one
           epoch of at least 30 steps: step ms and ex/s after the first
           step, finite losses, exactly 2 row-2 and 2 row-3 launches per
           step and no row-1 launch; then 20 steps on one batch with
           dropout off, whose loss must fall
  profile  device time, top kernels and device busy share (torch.profiler
           against an unprofiled wall clock) of one served batch of 64
           users x 300 candidates, of a 64-user corpus top-10, of one
           1024-row news-encoder chunk and of one headline train step
Then one JSON line of per-kernel numbers, and last the line
{"ok": true, "device": {...}}. Any failed phase raises: the exit code is
then not 0 and no result line is printed. Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Kernel vs plain version on the card. f32: the two sum in another order;
# bf16: a rounds to bf16 before a@v, so one ulp of a shows in the context.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (5e-2, 5e-2)}  # (rtol, atol)
# Served scores vs the same params on the CPU (f32, two devices' orders).
SERVE_TOL = (1e-4, 1e-4)
# Kernel rows 2-3 vs their plain versions: (forward, backward) tolerances.
TRAIN_TOL = {"float32": ((1e-5, 1e-5), (1e-4, 1e-4)),
             "bfloat16": ((5e-2, 5e-2), (5e-2, 5e-2))}
# Train step on the card vs the CPU (f32): loss rtol; each leaf's gradient
# within this share of that leaf's largest |gradient|.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_SHARE = 1e-4
# ... or within this share of the largest gradient of any leaf, whichever
# is larger. Some leaves' gradients nearly cancel: the key bias of each
# MHSA and the score bias of each pooling are 0 analytically (they shift
# all scores of a row alike), and on near-uniform attention the news
# pooling's gradients are tiny too. What is left of them is f32 rounding
# noise of two summation orders, about 1e-9 of the largest gradient.
TRAIN_GRAD_FLOOR = 1e-6
TPU_KERNELS = "newsrecommendation_tpu/ops/pallas/fused_attention.py"
REPLACES = f"{TPU_KERNELS}:199"
SOURCE = "newsrecommendation_tpu_torch/csrc/qkv_fwd.cu"
BWD_SOURCE = "newsrecommendation_tpu_torch/csrc/qkv_bwd_probs.cu"
NUM_NEWS = 65536
MAX_BATCH = 64
# Impressions of the synthetic corpus: about 2.4 training samples each,
# enough for one epoch of more than 30 steps at batch 128.
TRAIN_IMPRESSIONS = 2400
TRAIN_STEPS_MIN = 30
# The device the training phases run on; a rehearsal without a card sets
# it to "cpu" (the plain versions then stand in for the kernels).
DEVICE = "cuda"

_T0 = time.perf_counter()


def phase(label: str, t_start: float, **info) -> None:
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{label}] {time.perf_counter() - t_start:.3f}s "
          f"(total {time.perf_counter() - _T0:.3f}s) {extra}", flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn, reps: int = 10) -> dict:
    """Device time of ``fn`` per call by torch.profiler, its top kernels,
    and its share of the same loop's wall time measured without the
    profiler (the device's busy share; 1 - that is its idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's entry repeats its kernels' time
    dev = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in dev)
    if device_ms <= 0:
        fail("the profiler saw no device time")
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall_s * 1e3),
            "top_ms": [[k[:60], ms] for k, ms in dev[:8]]}


def n_outside(out, ref, rtol, atol) -> int:
    """Elements of out not within atol + rtol * |ref| of ref; a NaN on
    either side counts as outside."""
    err = (out.float() - ref.float()).abs()
    return int((~(err <= atol + rtol * ref.float().abs())).sum().item())


def kernel_case(fa, variant, n, t, heads, d, dtype, seed):
    """One kernel-vs-plain comparison with timings and the bound."""
    import torch
    import torch.nn.functional as F

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device="cuda").to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device="cuda")).to(tdt)
    mask = None
    if variant == "bias_masked":
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: its output is 0
    call = ((lambda: fa.exp_mhsa_qkv_bias(qkv, bias, heads)) if mask is None
            else (lambda: fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads)))
    out = call()
    ref = fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    rtol, atol = TOL[dtype]
    if not torch.isfinite(out.float()).all():
        fail(f"{variant} {dtype} N={n} T={t}: non-finite kernel output")
    if n_outside(out, ref, rtol, atol):
        fail(f"{variant} {dtype} N={n} T={t}: max |kernel - plain| "
             f"{err.max().item():.3e} over rtol {rtol} atol {atol}")
    if mask is not None and out[::7].abs().max().item() != 0.0:
        fail(f"{variant} {dtype}: fully masked rows are not 0")
    # controls: the same comparison must reject plain versions with a
    # planted fault, so a clean result above is not a blind check
    scale = 1.0 + 10 * rtol
    faults = {"bias dropped": (qkv, torch.zeros_like(bias), mask),
              f"inputs scaled by {scale}": (qkv * scale, bias * scale, mask)}
    if mask is not None:
        faults["mask dropped"] = (qkv, bias, None)
    caught = {}
    for name, args in faults.items():
        caught[name] = n_outside(
            out, fa.exp_mhsa_qkv_bias_reference(*args, heads), rtol, atol)
        if not caught[name]:
            fail(f"{variant} {dtype}: a plain version with {name} passed "
                 "the comparison")
    kernel_ms = time_ms(call)
    plain_ms = time_ms(
        lambda: fa.exp_mhsa_qkv_bias_reference(qkv, bias, mask, heads))
    # yardstick only: softmax attention on the same q, k, v (equal to this
    # function on rows with a key left, up to eps); the port never calls it
    x = (qkv + bias).view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        x[0], x[1], x[2], attn_mask=attn_mask))
    item = qkv.element_size()
    n_bytes = item * (n * t * 3 * hd + 3 * hd + n * t * hd)
    if mask is not None:
        n_bytes += 4 * n * t
    flops = 4 * n * heads * t * t * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {
        "variant": variant, "shape": [n, t, heads, d], "dtype": dtype,
        "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
        "n_differ": int((err != 0).sum().item()), "n_elems": err.numel(),
        "max_abs_ref": ref.float().abs().max().item(),
        "faults_caught": caught,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def n_differ(a, b) -> int:
    return int((a.float() != b.float()).sum().item())


def bwd_plain_with_fault(qkv, bias, probs, g, heads, *, rowsum=True,
                         round_a=True):
    """The plain backward of row 3 with a planted fault: the ds row-sum
    term dropped, or dv computed from the f32 a instead of a rounded to
    g's dtype."""
    import torch

    n, t, w3 = qkv.shape
    d = w3 // (3 * heads)
    x = (qkv + bias).view(n, t, 3, heads, d).float()
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    gh = g.view(n, t, heads, d).float()
    a = probs.view(n, t, heads, t).permute(0, 2, 1, 3)
    al = a.to(g.dtype).float() if round_a else a
    dv = torch.einsum("bhqk,bqhd->bkhd", al, gh)
    da = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    r = (da * a).sum(-1, keepdim=True) if rowsum else 0.0
    ds = ((da - r) * a * (1.0 / d ** 0.5)).to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([y.reshape(n, t, heads * d) for y in (dq, dk, dv)],
                     -1).to(qkv.dtype)


def train_kernel_case(fa, variant, n, t, heads, d, dtype, seed):
    """Rows 2 and 3 against their plain versions on the card, with planted
    faults, timings and bounds."""
    import torch

    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(100 + seed)
    hd = heads * d
    qkv = torch.randn((n, t, 3 * hd), generator=gen, device=DEVICE).to(tdt)
    bias = (0.5 * torch.randn((3 * hd,), generator=gen, device=DEVICE)).to(tdt)
    g = torch.randn((n, t, hd), generator=gen, device=DEVICE).to(tdt)
    mask = None
    if variant == "bias_masked":
        mask = (torch.rand((n, t), generator=gen, device=DEVICE) > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0  # every 7th row fully masked: probs and output 0
    (f_rtol, f_atol), (b_rtol, b_atol) = TRAIN_TOL[dtype]
    where = f"{variant} {dtype} N={n} T={t}"

    ctx, probs = fa.qkv_fwd_probs(qkv, bias, mask, heads)
    row1 = (fa.exp_mhsa_qkv_bias(qkv, bias, heads) if mask is None
            else fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, heads))
    ref_ctx, ref_probs = fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias,
                                                              mask, heads)
    dqkv = fa.qkv_bwd_probs(qkv, bias, ref_probs, g, heads)
    ref_dqkv = fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g, heads)
    dqkv.sum().item()  # waits for the kernels
    if not torch.equal(ctx, row1):
        fail(f"{where}: row 2's context is not row 1's bit for bit")
    checks = {"ctx": (ctx, ref_ctx, f_rtol, f_atol),
              "probs": (probs, ref_probs, *TRAIN_TOL["float32"][0]),
              "dqkv": (dqkv, ref_dqkv, b_rtol, b_atol)}
    out = {"variant": variant, "shape": [n, t, heads, d], "dtype": dtype}
    for name, (got, want, rtol, atol) in checks.items():
        if not torch.isfinite(got.float()).all():
            fail(f"{where}: non-finite {name}")
        if n_outside(got, want, rtol, atol):
            fail(f"{where}: {name} max |kernel - plain| "
                 f"{(got.float() - want.float()).abs().max().item():.3e} "
                 f"over rtol {rtol} atol {atol}")
        out[name] = {"max_abs_err": (got.float() - want.float()).abs()
                     .max().item(), "n_differ": n_differ(got, want),
                     "n_elems": got.numel(),
                     "max_abs_ref": want.float().abs().max().item(),
                     "rtol": rtol, "atol": atol}
    if mask is not None and (probs[::7].abs().max().item() != 0.0
                             or dqkv[::7].abs().max().item() != 0.0):
        fail(f"{where}: fully masked rows have probs or dqkv not 0")
    # controls: the same comparisons must reject plain versions with a
    # planted fault. A fault that moves bf16 results by less than the bf16
    # tolerance (dv from the unrounded a) is rejected when it differs from
    # the kernel in more than 10x as many elements as the plain version
    # does: a kernel that lacked that rounding would differ as much.
    transposed = ref_probs.view(n, t, heads, t).permute(0, 3, 2, 1).reshape(
        n, t, heads * t)
    caught = {"probs transposed per head": n_outside(
        probs, transposed, *TRAIN_TOL["float32"][0])}
    no_rowsum = bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                     rowsum=False)
    caught["ds without its row-sum term"] = n_outside(dqkv, no_rowsum,
                                                      b_rtol, b_atol)
    if dtype == "bfloat16":
        f32_a = bwd_plain_with_fault(qkv, bias, ref_probs, g, heads,
                                     round_a=False)
        base = out["dqkv"]["n_differ"]
        fault_differ = n_differ(dqkv, f32_a)
        caught["dv from the f32 a (differing elements)"] = (
            fault_differ if n_outside(dqkv, f32_a, b_rtol, b_atol)
            or fault_differ > 10 * max(base, 1) else 0)
    for name, count in caught.items():
        if not count:
            fail(f"{where}: a plain version with {name} passed the "
                 "comparison")
    out["faults_caught"] = caught

    item = qkv.element_size()
    mask_bytes = 0 if mask is None else 4 * n * t
    fwd_bytes = (item * (n * t * 3 * hd + 3 * hd + n * t * hd)
                 + 4 * n * t * heads * t + mask_bytes)
    bwd_bytes = (item * (2 * n * t * 3 * hd + 3 * hd + n * t * hd)
                 + 4 * n * t * heads * t)
    for name, fn, plain, n_bytes, flops in (
            ("fwd", lambda: fa.qkv_fwd_probs(qkv, bias, mask, heads),
             lambda: fa.exp_mhsa_qkv_bias_probs_reference(qkv, bias, mask,
                                                          heads),
             fwd_bytes, 4 * n * heads * t * t * d),
            ("bwd", lambda: fa.qkv_bwd_probs(qkv, bias, ref_probs, g, heads),
             lambda: fa.qkv_bwd_probs_reference(qkv, bias, ref_probs, g,
                                                heads),
             bwd_bytes, 8 * n * heads * t * t * d)):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = {"ms": time_ms(fn), "plain_ms": time_ms(plain),
                     "library_ms": None, "bytes": n_bytes, "flops": flops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def train_setup(cfg, table, seed, device):
    from newsrecommendation_tpu_torch.models import get_model, nrms
    from newsrecommendation_tpu_torch.train import create_train_state

    params = nrms.init(cfg, table, seed=seed, device=device)
    return get_model("NRMS"), create_train_state(cfg, params)


def train_check(ctx, user_log_mask):
    """One f32 step with dropout off on the card and on the CPU from the
    same params and batch: loss, every leaf's gradient, the frozen table."""
    import torch

    from newsrecommendation_tpu_torch.train import make_train_step

    cfg = ctx["cfg"].replace(batch_size=16, deterministic=True, lr=3e-4,
                             freeze_embedding=True,
                             user_log_mask=user_log_mask)
    host = next(ctx["samples"].iter_batches(ctx["feats"], cfg.batch_size,
                                            epoch=0, seed=0))
    results = {}
    for device in (DEVICE, "cpu"):
        model, state = train_setup(cfg, ctx["table"], 1, device)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        state, metrics = make_train_step(cfg, model)(state, batch, 0)
        results[device] = (float(metrics["loss"]), state.params)
    (loss, params), (cpu_loss, cpu_params) = results[DEVICE], results["cpu"]
    if not abs(loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss):
        fail(f"train-check: loss {loss} on the card, {cpu_loss} on the CPU")
    table = params["embedding_table"]
    if table.grad is not None or not torch.equal(
            table.cpu(), torch.from_numpy(ctx["table"])):
        fail("train-check: the frozen table took a gradient or moved")
    grads = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], path + (key,))
            return
        if path == ("embedding_table",):
            return
        if (a.grad is None) != (b.grad is None):
            fail(f"train-check: {path} has a gradient on one device only")
        if a.grad is not None:
            grads[path] = (a.grad.cpu(), b.grad)

    walk(params, cpu_params, ())
    largest = max(g.abs().max().item() for _, g in grads.values())
    floor = TRAIN_GRAD_FLOOR * largest
    worst, under_floor = {}, {}
    for path, (g, cpu_g) in grads.items():
        scale = cpu_g.abs().max().item()
        err = (g - cpu_g).abs().max().item()
        if TRAIN_GRAD_SHARE * scale < floor:
            under_floor["/".join(path)] = [scale, err]
        else:
            worst["/".join(path)] = err / scale
        if not err <= max(TRAIN_GRAD_SHARE * scale, floor):
            fail(f"train-check: {path} gradient differs by {err:.3e}, "
                 f"over {TRAIN_GRAD_SHARE} of its max {scale:.3e} and "
                 f"over {TRAIN_GRAD_FLOOR} of the largest {largest:.3e}")
    return {"loss": loss, "cpu_loss": cpu_loss,
            "worst_grad_share": max(worst.values()),
            "worst_leaf": max(worst, key=worst.get),
            "largest_grad": largest,
            "under_floor_max_and_err": under_floor}


def train_run(ctx, fa):
    """The headline training step through fit(), then 20 steps on one
    batch with dropout off. Launch counts are reset just before fit and
    read just after."""
    import torch

    from newsrecommendation_tpu_torch.train import fit, make_train_step

    cfg = ctx["cfg"].replace(
        compute_dtype="bfloat16", batch_size=128, npratio=4, lr=3e-4,
        drop_rate=0.2, freeze_embedding=True, device_gather=True,
        prefetch_depth=2, log_steps=10, epochs=1, seed=0,
        deterministic=False)
    samples, feats = ctx["samples"], ctx["feats"]
    model, state = train_setup(cfg, ctx["table"], 2, DEVICE)
    step = make_train_step(cfg, model, device_gather=True)
    losses = []

    def recorded(*args):
        st, metrics = step(*args)
        losses.append(metrics["loss"])  # stays on the card
        return st, metrics

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    state, stats = fit(cfg, model, state, samples, feats,
                       train_step=recorded, device_gather=True)
    float(losses[-1])  # waits for the last step
    wall_s = time.perf_counter() - t0
    launches = {k: fa.launch_counts(k) for k in fa.KERNELS}
    steps = stats["steps"]
    if steps < TRAIN_STEPS_MIN or steps != len(losses):
        fail(f"train: {steps} steps ({len(losses)} recorded), fewer than "
             f"{TRAIN_STEPS_MIN}")
    if not torch.isfinite(torch.stack(losses)).all():
        fail("train: a non-finite loss")
    want = {"qkv_fwd": {"bias": 0, "bias_masked": 0},
            "qkv_fwd_probs": {"bias_probs": 2 * steps,
                              "bias_masked_probs": 0},
            "qkv_bwd_probs": {"bwd_probs": 2 * steps}}
    if launches != want:
        fail(f"train: launches {launches}, expected {want}")

    fixed_cfg = cfg.replace(deterministic=True)
    _, fixed = train_setup(fixed_cfg, ctx["table"], 3, DEVICE)
    fixed_step = make_train_step(fixed_cfg, model, device_gather=True)
    feats_dev = torch.from_numpy(feats).to(DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in next(
        samples.iter_index_batches(cfg.batch_size, epoch=0, seed=1)).items()}
    fixed_losses = []
    for _ in range(20):
        fixed, metrics = fixed_step(fixed, batch, 0, feats_dev)
        fixed_losses.append(metrics["loss"])
    fixed_losses = [float(x) for x in fixed_losses]
    if not (np.isfinite(fixed_losses).all()
            and fixed_losses[-1] < fixed_losses[0]):
        fail(f"train: fixed-batch loss did not fall: {fixed_losses}")
    ex_s = stats["examples_per_sec"]
    return {"steps": steps, "samples": samples.num_samples,
            "examples_per_sec": ex_s,
            "step_ms": 1e3 * cfg.batch_size / ex_s if ex_s else None,
            "fit_wall_s": wall_s, "first_loss": float(losses[0]),
            "final_loss": stats["final_loss"],
            "final_acc": stats["final_acc"],
            "fixed_batch_loss": [fixed_losses[0], fixed_losses[-1]],
            "launches": launches}, (cfg, model, state, step)


def http_call(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t0 = time.perf_counter()
        conn.request(method, path,
                     body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"{method} {path} -> {resp.status}: {body}")
    return body, ms


def cpu_scores(nrms, cpu_params, cfg, feats, news_index, history, cands):
    """Scores of one request from the same params on the CPU, through the
    plain versions, encoding only the news rows the request touches."""
    import torch

    from newsrecommendation_tpu_torch.data.loader import (
        pad_to_fix_len,
        trans_to_nindex,
    )

    hist, mask = pad_to_fix_len(trans_to_nindex(history, news_index),
                                cfg.user_log_length)
    cand = trans_to_nindex(cands, news_index)
    rows = sorted(set(hist) | set(cand) | {0})
    pos = {r: i for i, r in enumerate(rows)}
    with torch.inference_mode():
        vecs = nrms.news_encoder(cpu_params, cfg,
                                 torch.from_numpy(feats[rows]))
        hv = vecs[[pos[r] for r in hist]][None]
        user = nrms.user_encoder(cpu_params, cfg, hv,
                                 torch.from_numpy(mask)[None])[0]
        return (vecs[[pos[r] for r in cand]] @ user).numpy()


def check_close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rtol, atol = SERVE_TOL
    err = np.abs(got - want)
    if got.shape != want.shape or not np.isfinite(got).all() or (
            err > atol + rtol * np.abs(want)).any():
        fail(f"{name}: served scores disagree with the CPU plain run "
             f"(max abs err {err.max() if err.size else 'n/a'})")
    return float(err.max())


def serve_run(ctx, user_log_mask):
    """One serving run: build the Recommender on the card, start the HTTP
    server, answer requests, check two against the CPU."""
    import torch

    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.server import serve

    cfg = ctx["cfg"].replace(user_log_mask=user_log_mask)
    t0 = time.perf_counter()
    rec = Recommender.from_state(cfg, ctx["params"], ctx["news_index"],
                                 ctx["feats"], device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cache = rec.news_scoring[:rec.corpus_size + 1]
    if not torch.isfinite(cache).all() or cache.shape != (NUM_NEWS + 1, 400):
        fail(f"corpus cache {tuple(cache.shape)} not finite or mis-shaped")
    srv = serve(rec, port=0, max_batch=MAX_BATCH, max_delay_ms=2.0)
    port = srv.server_address[1]
    try:
        rng = np.random.default_rng(7 + user_log_mask)
        ids = [f"N{i}" for i in range(1, NUM_NEWS + 1)]

        def request(c, h):
            return ([ids[j] for j in rng.integers(0, NUM_NEWS, h)],
                    [ids[j] for j in rng.choice(NUM_NEWS, c, replace=False)])

        lat = {"score": [], "recommend": [], "score_concurrent": []}
        checked = []
        for c, h in [(10, 5), (50, 20), (100, 50), (300, 30), (300, 80)]:
            hist, cands = request(c, h)
            body, ms = http_call(port, "POST", "/score",
                                 {"history": hist, "candidates": cands})
            lat["score"].append(ms)
            if len(body["scores"]) != c or len(body["ranked"]) != c:
                fail(f"/score returned {len(body['scores'])} of {c} scores")
            if c == 300 and len(checked) < 1:
                checked.append(check_close(
                    "/score", body["scores"], cpu_scores(
                        ctx["nrms"], ctx["cpu_params"], cfg, ctx["feats"],
                        ctx["news_index"], hist, cands)))
        # concurrent requests coalesce into one padded MAX_BATCH batch
        reqs = [request(100, 40) for _ in range(16)]
        results = [None] * len(reqs)

        def worker(i):
            results[i] = http_call(port, "POST", "/score",
                                   {"history": reqs[i][0],
                                    "candidates": reqs[i][1]})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        if any(th.is_alive() for th in threads) or None in results:
            fail("concurrent /score requests did not all complete")
        lat["score_concurrent"] = [ms for _, ms in results]
        checked.append(check_close(
            "/score (batched)", results[3][0]["scores"], cpu_scores(
                ctx["nrms"], ctx["cpu_params"], cfg, ctx["feats"],
                ctx["news_index"], *reqs[3])))
        for h in (3, 25, 60):
            hist, _ = request(1, h)
            body, ms = http_call(port, "POST", "/recommend",
                                 {"history": hist, "k": 10})
            lat["recommend"].append(ms)
            if len(body["doc_ids"]) != 10 or len(set(body["doc_ids"])) != 10:
                fail(f"/recommend returned {body['doc_ids']}")
            got = np.asarray(body["scores"])
            if (np.diff(got) > 0).any():
                fail("/recommend scores are not in descending order")
            checked.append(check_close(
                "/recommend", got, cpu_scores(
                    ctx["nrms"], ctx["cpu_params"], cfg, ctx["feats"],
                    ctx["news_index"], hist, body["doc_ids"])))
        health, _ = http_call(port, "GET", "/healthz")
        stats, _ = http_call(port, "GET", "/stats")
        if health["corpus_size"] != NUM_NEWS or stats["errors"] != 0:
            fail(f"healthz {health} stats {stats}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
    return {"encode_s": encode_s, "latency_ms": lat,
            "max_abs_err_vs_cpu": max(checked), "stats": stats}, rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # ---- device ----------------------------------------------------------
    t = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    phase("device", t, name=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    # ---- build -----------------------------------------------------------
    t = time.perf_counter()
    sos = fa.build()  # one nvcc per source, all started together
    phase("build", t, **{k: os.path.relpath(v) for k, v in sos.items()})

    # ---- kernel vs plain -------------------------------------------------
    t = time.perf_counter()
    cases = []
    shapes = [("bias", 1024, 20), ("bias", 7040, 20), ("bias", MAX_BATCH, 50),
              ("bias_masked", 512, 50), ("bias_masked", MAX_BATCH, 50)]
    for i, (variant, n, tl) in enumerate(shapes):
        for dtype in ("float32", "bfloat16"):
            c = kernel_case(fa, variant, n, tl, 20, 20, dtype, seed=i)
            cases.append(c)
            print("  kernel " + json.dumps(c), flush=True)
    phase("kernel", t, cases=len(cases))

    # ---- kernel rows 2-3 vs plain ------------------------------------------
    t = time.perf_counter()
    train_cases = []
    for i, (variant, n, tl) in enumerate([("bias", 7040, 20), ("bias", 128, 50),
                                          ("bias_masked", 128, 50)]):
        for dtype in ("float32", "bfloat16"):
            c = train_kernel_case(fa, variant, n, tl, 20, 20, dtype, seed=i)
            train_cases.append(c)
            print("  kernel-train " + json.dumps(c), flush=True)
    phase("kernel-train", t, cases=len(train_cases))

    # ---- serve at NRMS's published width ----------------------------------
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        build_news_features,
        random_word_embeddings,
        read_news,
    )
    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.data.prepare import (
        prepare_training_data,
    )
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.models import nrms
    from newsrecommendation_tpu_torch.utils import to_device

    t = time.perf_counter()
    cfg = Config()  # 300-d words, 400-d news, 20 heads x 20, T=20, L=50
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, num_news=NUM_NEWS, num_users=100,
                        num_impressions=TRAIN_IMPRESSIONS,
                        title_len=cfg.num_words_title, max_history=80,
                        seed=0)
        corpus = read_news(os.path.join(tmp, "news.tsv"), cfg)
        prepare_training_data(tmp, 1, cfg.npratio, seed=0)
        samples = TrainSamples.from_file(
            os.path.join(tmp, f"behaviors_np{cfg.npratio}_0.tsv"),
            corpus.news_index, cfg)
    feats = build_news_features(corpus, cfg)
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    params = nrms.init(cfg, table, seed=0, device="cuda")
    ctx = {"cfg": cfg, "params": params, "feats": feats, "nrms": nrms,
           "news_index": corpus.news_index, "table": table,
           "samples": samples, "cpu_params": to_device(params, "cpu")}
    phase("corpus", t, news=corpus.num_news, vocab=len(corpus.word_dict),
          train_samples=samples.num_samples)

    fa.reset_launch_counts()
    runs = {}
    for user_log_mask in (False, True):
        t = time.perf_counter()
        before = fa.launch_counts()
        runs[user_log_mask], rec = serve_run(ctx, user_log_mask)
        after = fa.launch_counts()
        runs[user_log_mask]["launches"] = {k: after[k] - before[k]
                                           for k in after}
        phase(f"serve user_log_mask={user_log_mask}", t,
              **{k: json.dumps(v) for k, v in runs[user_log_mask].items()})
    launches = fa.launch_counts("qkv_fwd")
    if min(launches.values()) < 1:
        fail(f"a kernel of the serving path never launched: {launches}")
    if runs[False]["launches"]["bias_masked"] or not (
            runs[True]["launches"]["bias_masked"]):
        fail(f"masked kernel launches do not follow user_log_mask: {runs}")

    # ---- training ------------------------------------------------------------
    for user_log_mask in (False, True):
        t = time.perf_counter()
        res = train_check(ctx, user_log_mask)
        phase(f"train-check user_log_mask={user_log_mask}", t,
              **{k: json.dumps(v) for k, v in res.items()})
    t = time.perf_counter()
    train, (tcfg, tmodel, tstate, tstep) = train_run(ctx, fa)
    phase("train", t, **{k: json.dumps(v) for k, v in train.items()})

    # ---- where the device time goes (after the counts were read) ----------
    t = time.perf_counter()
    rng = np.random.default_rng(11)
    ids = [f"N{i}" for i in range(1, NUM_NEWS + 1)]
    hists = [[ids[j] for j in rng.integers(0, NUM_NEWS, 50)]
             for _ in range(MAX_BATCH)]
    cands = [[ids[j] for j in rng.choice(NUM_NEWS, 300, replace=False)]
             for _ in range(MAX_BATCH)]
    chunk = torch.from_numpy(feats[1:cfg.eval_news_chunk + 1]).cuda()

    def encode_chunk():
        with torch.inference_mode():
            nrms.news_encoder(rec.params, cfg, chunk)

    train_feats = torch.from_numpy(feats).cuda()
    train_batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        ctx["samples"].iter_index_batches(tcfg.batch_size, epoch=0,
                                          seed=2)).items()}

    def train_step():
        tstep(tstate, train_batch, tcfg.seed, train_feats)

    prof = {"score_batch_64x300": profile_device(
                lambda: rec.score_batch(hists, cands)),
            "recommend_batch_64_k10": profile_device(
                lambda: rec.recommend_batch(hists, k=10)),
            "news_encoder_chunk_1024": profile_device(encode_chunk),
            "train_step_b128_bf16": profile_device(train_step)}
    phase("profile", t, **{k: json.dumps(v) for k, v in prof.items()})

    # ---- summary -----------------------------------------------------------
    main_path = {"bias": ("bias", 1024, 20, "float32"),
                 "bias_masked": ("bias_masked", MAX_BATCH, 50, "float32")}
    kernels = []
    for variant, (v, n, tl, dtype) in main_path.items():
        c = next(c for c in cases if (c["variant"], c["shape"][0],
                                      c["shape"][1], c["dtype"])
                 == (v, n, tl, dtype))
        kernels.append({
            "name": f"exp_mhsa_qkv_{variant}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": launches[variant],
            "max_abs_err": c["max_abs_err"], "n_differ": c["n_differ"],
            "n_elems": c["n_elems"], "max_abs_ref": c["max_abs_ref"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "shape": c["shape"],
            "dtype": c["dtype"]})
    # rows 2-3 at the news encoder's shape in the headline step (bf16)
    c = next(c for c in train_cases if (c["variant"], c["shape"][0],
                                        c["dtype"]) == ("bias", 7040,
                                                        "bfloat16"))
    rows = [("exp_mhsa_qkv_bias_probs", SOURCE, f"{TPU_KERNELS}:601",
             train["launches"]["qkv_fwd_probs"]["bias_probs"], "fwd",
             c["probs"]),
            ("qkv_bwd_probs", BWD_SOURCE, f"{TPU_KERNELS}:642",
             train["launches"]["qkv_bwd_probs"]["bwd_probs"], "bwd",
             c["dqkv"])]
    for name, source, replaces, n_launch, half, err in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": err["max_abs_err"], "n_differ": err["n_differ"],
            "n_elems": err["n_elems"], "max_abs_ref": err["max_abs_ref"],
            "ms": c[half]["ms"], "plain_ms": c[half]["plain_ms"],
            "bound_ms": c[half]["bound_ms"], "bound_by": c[half]["bound_by"],
            "library_ms": None, "shape": c["shape"], "dtype": c["dtype"]})
    print(json.dumps({"kernels": kernels, "card": card,
                      "total_s": time.perf_counter() - _T0}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
