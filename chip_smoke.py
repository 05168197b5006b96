#!/usr/bin/env python3
"""Smoke run of the PyTorch port (newsrecommendation_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernel, holds it against its plain PyTorch
version, then serves NRMS at its published width over HTTP.

    python3 chip_smoke.py        # from the repo root, on a machine with
                                 # one CUDA card and nvcc

Phases, each printing one line with its elapsed seconds:
  device   nvidia-smi name and power limit; TF32 off for matmuls and convs
  build    nvcc builds csrc/qkv_fwd.cu for sm_90a (skipped if built)
  kernel   both kernel variants vs the plain version, f32 and bf16, at the
           shapes the serving path gives them, with the count of elements
           that differ at all; controls with a planted fault (bias dropped,
           inputs scaled, mask dropped) that the comparison must reject;
           kernel / plain / scaled_dot_product_attention times and the
           memory/flop bound
  serve    a 65,536-news synthetic corpus, full-width NRMS params from a
           seed, Recommender.from_state on cuda, the HTTP server on a free
           localhost port, /score (C up to 300) and /recommend (k=10)
           requests, once with user_log_mask False and once True; served
           scores checked against the same params run on the CPU through
           the plain versions; launch counts read around both runs
  profile  device time, top kernels and device busy share (torch.profiler
           against an unprofiled wall clock) of one served batch of 64
           users x 300 candidates, of a 64-user corpus top-10, and of one
           1024-row news-encoder chunk
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
REPLACES = "newsrecommendation_tpu/ops/pallas/fused_attention.py:199"
SOURCE = "newsrecommendation_tpu_torch/csrc/qkv_fwd.cu"
NUM_NEWS = 65536
MAX_BATCH = 64

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
            "top_ms": [[k[:60], ms] for k, ms in dev[:5]]}


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
    so = fa.build()
    phase("build", t, so=os.path.relpath(so))

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

    # ---- serve at NRMS's published width ----------------------------------
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        build_news_features,
        random_word_embeddings,
        read_news,
    )
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.models import nrms
    from newsrecommendation_tpu_torch.utils import to_device

    t = time.perf_counter()
    cfg = Config()  # 300-d words, 400-d news, 20 heads x 20, T=20, L=50
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, num_news=NUM_NEWS, num_users=100,
                        num_impressions=10, title_len=cfg.num_words_title,
                        seed=0)
        corpus = read_news(os.path.join(tmp, "news.tsv"), cfg)
    feats = build_news_features(corpus, cfg)
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    params = nrms.init(cfg, table, seed=0, device="cuda")
    ctx = {"cfg": cfg, "params": params, "feats": feats, "nrms": nrms,
           "news_index": corpus.news_index,
           "cpu_params": to_device(params, "cpu")}
    phase("corpus", t, news=corpus.num_news, vocab=len(corpus.word_dict))

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
    launches = fa.launch_counts()
    if min(launches.values()) < 1:
        fail(f"a kernel of the serving path never launched: {launches}")
    if runs[False]["launches"]["bias_masked"] or not (
            runs[True]["launches"]["bias_masked"]):
        fail(f"masked kernel launches do not follow user_log_mask: {runs}")

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

    prof = {"score_batch_64x300": profile_device(
                lambda: rec.score_batch(hists, cands)),
            "recommend_batch_64_k10": profile_device(
                lambda: rec.recommend_batch(hists, k=10)),
            "news_encoder_chunk_1024": profile_device(encode_chunk)}
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
    print(json.dumps({"kernels": kernels, "card": card,
                      "total_s": time.perf_counter() - _T0}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
