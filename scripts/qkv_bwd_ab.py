#!/usr/bin/env python3
"""One side of an A/B of the fused-qkv attention (rows 1-4, with rows 11
and 15-16 beside them) on one NVIDIA GPU: run it from the root of each
checkout in turn, in one process per run, on the same card (parent,
change, change, parent) and compare the lines it prints.

    python3 scripts/qkv_bwd_ab.py LABEL [--limits] [--plans] [--save DIR]

It prints one line, ``AB {json}``, with:
  - rows 3 (qkv_bwd_probs, from the probs row 2 writes) and 4 (qkv_bwd),
    unmasked and key-masked, at (N, T) = (64, 511), (128, 300), (7040,
    20) and (128, 50), 20 heads of 20, in bf16 (and (7040, 20), (128, 50)
    in f32 too), and row 12 (qkv2d_bwd) unmasked at (7040, 20) and
    (128, 50): a hash of each output on fixed inputs, so two checkouts
    can be held equal bit for bit, and its ms (CUDA events over 10
    calls); at (7040, 20) and (128, 50) also the plain versions' ms and
    scaled_dot_product_attention's backward alone (``sdpa``, the forward
    outside the timed window) on the same q, k, v;
  - rows 1 (qkv_fwd) and 2 (qkv_fwd_probs: context and probs) at every
    shape of FWD_CASES, hashes, ms and launches per regime (empty where
    the checkout counts none), and there the count of elements of dqkv in
    which row 4 differs from row 3 fed row 2's probs (``row3v4``: equal
    where both paths take one order of sums); row 11 (qkv2d_fwd) at
    (7040, 20) bf16;
    rows 15-16 (blanes_fwd, blanes_bwd) at BLANES_CASES, hashes and ms,
    and at T <= 64 the count of dqkv elements in which row 16 differs from
    row 4 on the same biased qkv (``row16v4``);
  - rows 13 (fused_tail_fwd) and 14 (fused_tail_bwd) at TAIL_CASES: a hash
    of each output (out; dqkv, dw1, db1, dw2, db2), ms and launches per
    regime; with --save DIR each case's outputs go to DIR the first time,
    and a later run with another label counts the elements of each output
    that differ from them (``tail_vs``); and in bf16, masked, dropout 0.2,
    at (128, T) for T = 64, 50, 20 on the card tests' inputs
    (``tests/test_torch_kernel_gpu.py`` ``_tail_inputs``, seeds 12-14),
    the elements of out and dqkv outside the card tests' bf16 tolerance
    against the plain versions and the elements that differ from them
    (``tail_precision``);
  - the device ms (chip_smoke.profile_device) of two training steps of
    NRMS at its published width in bf16, batch 128, 1+4 candidates, on a
    synthetic corpus of 8,192 news: with the fused encoder tail at the
    headline step's 50-news histories and at 512 (row 4's part of row 14
    at T = 512), and with 300-news histories (rows 2-3 at T = 300), with
    their launches of rows 2-4 and 13-14.
With --limits (a checkout that takes those shapes) it also times, kernel
and plain version, the paths past the old limits: rows 1 and 4 at 8 heads
of 50 and T = 400 (f32: row 1's and row 4's working sets in global
slots; bf16: row 4 on tensor cores), rows 9-10 on the wide kernels at
(8, 512) with 5 heads of 80, (4, 512) with 1 head of 400 and (2, 512)
with 1 head of 1100, rows 15-16 through the fused-qkv kernels at 5 heads
of 80, T = 512, and rows 13-14 at (2, 7000) with 4 heads of 20.
With --plans (a checkout whose row 3 stages its probs) it also times row
3 at (64, 511) and (128, 300) in bf16 under other launch plans: each
side in turn with tiles of 64 or 128 and (chunk, buffers) of (32, 1),
(32, 2), (64, 1), (64, 2), (128, 1), (128, 2) or (256, 1) where they fit,
the other side on the default plan; each with its output hash, which the
plan must not change.
It uses the checkout's own package and chip_smoke.py, so it runs on older
checkouts too. Without CUDA it exits 1.
"""

import hashlib
import json
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())

# Rows 1-2: (N, T, dtype, key masks) at 20 heads of 20 -- the corpus
# encoder's chunk, the served user encoder and its 512-user batch, the
# headline step's news and user encoders, and the user encoder over 300-
# and 511-news histories.
FWD_CASES = (("float32", 1024, 20, (False,)),
             ("float32", 64, 50, (False, True)),
             ("float32", 512, 50, (True,)),
             ("bfloat16", 7040, 20, (False, True)),
             ("float32", 7040, 20, (False,)),
             ("bfloat16", 128, 50, (False, True)),
             ("float32", 128, 50, (False, True)),
             ("bfloat16", 128, 300, (False, True)),
             ("float32", 128, 300, (False, True)),
             ("bfloat16", 64, 511, (False, True)),
             ("float32", 64, 511, (False, True)))
# Rows 15-16 (whose resident forward rows 1-2 now share): (N, T, dtype).
BLANES_CASES = (("bfloat16", 7040, 20), ("float32", 7040, 20),
                ("bfloat16", 128, 50), ("float32", 128, 50),
                ("float32", 128, 64), ("bfloat16", 64, 511))


# Rows 13-14: (dtype, N, T, masked, dropout) at 20 heads of 20, Q = 200 --
# the headline step's news and user encoders, the corpus encoder's chunk
# and the served user encoder (f32, dropout off), and the user encoder over
# 512-news histories.
TAIL_CASES = (("bfloat16", 7040, 20, False, True),
              ("bfloat16", 128, 50, False, True),
              ("bfloat16", 128, 50, True, True),
              ("float32", 1024, 20, False, False),
              ("float32", 64, 50, False, False),
              ("float32", 64, 50, True, False),
              ("bfloat16", 128, 512, True, True))


def _hash(x):
    import torch

    bits = x.contiguous().view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def _inputs(n, t, dtype, masked, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((n, t, 1200), generator=gen, device="cuda").to(dtype)
    bias = (0.5 * torch.randn((1200,), generator=gen, device="cuda")).to(
        dtype)
    g = torch.randn((n, t, 400), generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    return qkv, bias, g, mask


def _rows_1_2(cs, out):
    """Rows 1-2 at FWD_CASES, row 11 at (7040, 20) bf16, rows 15-16 at
    BLANES_CASES: hashes, ms and (rows 1-2) launches per regime."""
    import torch

    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    def regimes(k):
        return (kernels.regime_counts(k)
                if hasattr(kernels, "regime_counts") else {})

    for dtype, n, t, masks in FWD_CASES:
        for masked in masks:
            qkv, bias, g, mask = _inputs(n, t, getattr(torch, dtype), masked,
                                         5)
            name = f"{dtype} {n}x{t}{'m' if masked else ''}"

            def row1():
                return (fa.exp_mhsa_qkv_bias_masked(qkv, bias, mask, 20)
                        if mask is not None
                        else fa.exp_mhsa_qkv_bias(qkv, bias, 20))

            def row2():
                return fa.qkv_fwd_probs(qkv, bias, mask, 20)

            kernels.reset_launch_counts()
            with torch.inference_mode():
                h1 = _hash(row1())
                h2 = [_hash(x) for x in row2()]
            got = {k: regimes(k) for k in ("qkv_fwd", "qkv_fwd_probs")}
            out[f"row1 {name}"] = [h1, cs.time_ms(row1, 10), got["qkv_fwd"]]
            out[f"row2 {name}"] = [h2, cs.time_ms(row2, 10),
                                   got["qkv_fwd_probs"]]
            with torch.inference_mode():
                d3 = fa.qkv_bwd_probs(qkv, bias, row2()[1], g, 20)
                d4 = fa.qkv_bwd(qkv, bias, mask, g, 20)
                out[f"row3v4 {name}"] = [int((d3 != d4).sum()), d3.numel()]
            del d3, d4
            print(f"  {name}: row1 {out[f'row1 {name}']} row2 "
                  f"{out[f'row2 {name}']}", flush=True)
    qkv, bias, _, _ = _inputs(7040, 20, torch.bfloat16, False, 5)

    def row11():
        return q2.qkv2d_fwd(qkv.view(7040 * 20, -1), bias, 20, 20)

    out["row11 bfloat16 7040x20"] = [[_hash(x) for x in row11()],
                                     cs.time_ms(row11, 10)]
    for dtype, n, t in BLANES_CASES:
        for masked in (False, True):
            qkv, _, g, mask = _inputs(n, t, getattr(torch, dtype), masked, 6)
            name = f"{dtype} {n}x{t}{'m' if masked else ''}"

            def row15():
                return bl.blanes_fwd(qkv, mask, 20)

            def row16():
                return bl.blanes_bwd(qkv, mask, g, 20)

            for row, fn in (("row15", row15), ("row16", row16)):
                out[f"{row} {name}"] = [_hash(fn()), cs.time_ms(fn, 10)]
            if t <= 64:
                with torch.inference_mode():
                    d16 = row16()
                    d4 = fa.qkv_bwd(qkv, qkv.new_zeros(1200), mask, g, 20)
                    out[f"row16v4 {name}"] = [int((d16 != d4).sum()),
                                              d16.numel()]
                del d16, d4


def _tail(cs, out, label, save):
    """Rows 13-14 at TAIL_CASES: hashes, ms, launches per regime; with
    ``save`` the outputs saved, or counted against another label's."""
    import torch

    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )
    from newsrecommendation_tpu_torch.ops import kernels

    names = ("out", "dqkv", "dw1", "db1", "dw2", "db2")
    for dtype, n, t, masked, dropout in TAIL_CASES:
        qkv, mask, pool, g = cs.tail_inputs(n, t, 20, 20, 200, dtype, masked,
                                            3)
        sd = torch.tensor([4242], dtype=torch.int32, device="cuda")
        args = (qkv, mask, *pool, sd, 20, 0.2, not dropout)
        name = f"{dtype} {n}x{t}{'m' if masked else ''}"

        def row13():
            return fe.fused_tail_fwd(*args)

        def row14():
            return fe.fused_tail_bwd(*args[:7], g, *args[7:])

        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = dict(zip(names, (row13(), *row14())))
        regimes = {k: (kernels.regime_counts(k)
                       if hasattr(kernels, "regime_counts") else {})
                   for k in ("fused_tail_fwd", "fused_tail_bwd")}
        iters = 3 if t > 100 else 10
        out[f"row13 {name}"] = [_hash(got["out"]), cs.time_ms(row13, iters),
                                regimes["fused_tail_fwd"]]
        out[f"row14 {name}"] = [[_hash(got[k]) for k in names[1:]],
                                cs.time_ms(row14, iters),
                                regimes["fused_tail_bwd"]]
        if save:
            path = os.path.join(save, f"tail {name}.pt")
            if not os.path.exists(path):
                torch.save({"label": label,
                            "outputs": {k: v.cpu() for k, v in got.items()}},
                           path)
            else:
                old = torch.load(path)
                if old["label"] != label:
                    out[f"tail_vs {name}"] = {
                        "against": old["label"],
                        **{k: [int((got[k].cpu() != v).sum()), v.numel()]
                           for k, v in old["outputs"].items()}}
        print(f"  {name}: row13 {out[f'row13 {name}']} row14 "
              f"{out[f'row14 {name}']}", flush=True)
        del got


def _tail_precision(out):
    """Rows 13-14 in bf16 against their plain versions on the card tests'
    inputs: per (T, seed), [out outside, dqkv outside, out differing, dqkv
    differing], and their totals."""
    import torch

    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )

    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from test_torch_kernel_gpu import BF16_TOL, _tail_inputs

    def counts(got, want):
        got, want = got.float(), want.float()
        outside = (got - want).abs() > (BF16_TOL["atol"]
                                        + BF16_TOL["rtol"] * want.abs())
        return int(outside.sum()), int((got != want).sum())

    res, total = {}, [0, 0, 0, 0]
    for t in (64, 50, 20):
        for seed in (12, 13, 14):
            qkv, mask, pool, g = _tail_inputs(128, t, 20, 20, 200,
                                              "bfloat16", seed=seed)
            sd = torch.tensor([991], dtype=torch.int32, device="cuda")
            args = (qkv, mask, *pool, sd, 20, 0.2, False)
            bargs = (*args[:7], g, *args[7:])
            o = counts(fe.fused_tail_fwd(*args),
                       fe.fused_tail_fwd_reference(*args))
            d = counts(fe.fused_tail_bwd(*bargs)[0],
                       fe.fused_tail_bwd_reference(*bargs)[0])
            res[f"T{t} s{seed}"] = [o[0], d[0], o[1], d[1]]
            total = [x + y for x, y in zip(total, res[f"T{t} s{seed}"])]
    out["tail_precision"] = {**res, "total": total}
    print(f"  tail_precision total {total}", flush=True)


def _limits(cs, out):
    import torch

    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import (
        experimental_fused_encoder as fe,
    )
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        gen = torch.Generator(device="cuda").manual_seed(9)
        qkv = torch.randn((16, 400, 1200), generator=gen,
                          device="cuda").to(dtype)
        bias = torch.zeros(1200, device="cuda", dtype=dtype)
        g = torch.randn((16, 400, 400), generator=gen, device="cuda").to(
            dtype)
        out[f"limits row1 {name} 16x400 h8"] = [
            cs.time_ms(lambda: fa.exp_mhsa_qkv_bias(qkv, bias, 8), 5),
            cs.time_ms(lambda: fa.exp_mhsa_qkv_bias_reference(
                qkv, bias, None, 8), 5)]
        out[f"limits row4 {name} 16x400 h8"] = [
            cs.time_ms(lambda: fa.qkv_bwd(qkv, bias, None, g, 8), 5),
            cs.time_ms(lambda: fa.qkv_bwd_reference(qkv, bias, None, g, 8),
                       5)]
        for n, heads, d in ((8, 5, 80), (4, 1, 400), (2, 1, 1100)):
            x = torch.randn((n, 512, 3 * heads * d), generator=gen,
                            device="cuda").to(dtype)
            gg = torch.randn((n, 512, heads * d), generator=gen,
                             device="cuda").to(dtype)
            q, k, v = torch.split(x, heads * d, dim=-1)
            o, m, den = bw.flash_fwd(q, k, v, None, heads)
            delta = bw.delta_of(gg, o, heads)
            key = f"{name} {n}x512 h{heads} d{d}"
            out[f"limits row9 {key}"] = [
                cs.time_ms(lambda: bw.flash_fwd(q, k, v, None, heads), 5),
                cs.time_ms(lambda: bw.flash_fwd_reference(q, k, v, None,
                                                          heads), 5)]
            out[f"limits row10 {key}"] = [
                cs.time_ms(lambda: bw.flash_bwd(q, k, v, None, gg, m, den,
                                                delta, heads), 5),
                cs.time_ms(lambda: bw.flash_bwd_reference(
                    q, k, v, None, gg, m, den, delta, heads), 5)]
            if d == 80:
                out[f"limits row15 {key}"] = [
                    cs.time_ms(lambda: bl.blanes_fwd(x, None, heads), 5),
                    cs.time_ms(lambda: bl.blanes_fwd_reference(x, None,
                                                               heads), 5)]
                out[f"limits row16 {key}"] = [
                    cs.time_ms(lambda: bl.blanes_bwd(x, None, gg, heads), 5),
                    cs.time_ms(lambda: bl.blanes_bwd_reference(
                        x, None, gg, heads), 5)]
        qkv, mask, pool, gt = cs.tail_inputs(2, 7000, 4, 20, 200, name, True,
                                             3)
        seed = torch.zeros(1, dtype=torch.int32, device="cuda")
        args = (qkv, mask, *pool, seed, 4, 0.0, True)
        out[f"limits row13 {name} 2x7000 h4"] = [
            cs.time_ms(lambda: fe.fused_tail_fwd(*args), 3),
            cs.time_ms(lambda: fe.fused_tail_fwd_reference(*args), 3)]
        out[f"limits row14 {name} 2x7000 h4"] = [
            cs.time_ms(lambda: fe.fused_tail_bwd(*args[:7], gt, *args[7:]),
                       3),
            cs.time_ms(lambda: fe.fused_tail_bwd_reference(
                *args[:7], gt, *args[7:]), 3)]


def _plans(cs, out):
    import torch

    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    default = fa.bwd_launch_plan
    for n, t in ((64, 511), (128, 300)):
        qkv, bias, g, _ = _inputs(n, t, torch.bfloat16, False, 5)
        _, probs = fa.qkv_fwd_probs(qkv, bias, None, 20)
        base = default(n, t, 20, 20, torch.bfloat16, probs=True)
        plans = {"default": base}
        for side in ("query", "key"):
            for tile in (64, 128):
                for chunk, nbuf in ((32, 1), (32, 2), (64, 1), (64, 2),
                                    (128, 1), (128, 2), (256, 1)):
                    kind = f"bwd_{side}_probs"
                    smem = bw.smem_bytes(kind, 20, 2, tile, chunk, nbuf)
                    if smem <= kernels.MAX_SMEM:
                        plans[f"{side} {tile} {chunk} {nbuf}"] = \
                            base._replace(**{side: bw.Launch(
                                kind, tile, chunk, nbuf, smem,
                                (n * 20, -(-t // tile)), 2 * tile)})
        for name, plan in plans.items():
            fa.bwd_launch_plan = lambda *a, _plan=plan, **k: _plan
            try:
                def fn():
                    return fa.qkv_bwd_probs(qkv, bias, probs, g, 20)

                out[f"plan row3 {n}x{t} {name}"] = [_hash(fn()),
                                                    cs.time_ms(fn, 10)]
            finally:
                fa.bwd_launch_plan = default


def _steps(cs, out):
    import torch

    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        build_news_features, random_word_embeddings, read_news)
    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.data.prepare import (
        prepare_training_data)
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.train import make_train_step

    cfg = Config()
    samples = {}
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, num_news=8192, num_users=100,
                        num_impressions=600, title_len=cfg.num_words_title,
                        max_history=600, seed=0)
        prepare_training_data(tmp, 1, cfg.npratio, seed=0)
        corpus = read_news(os.path.join(tmp, "news.tsv"), cfg)
        for length in (50, 512, 300):
            samples[length] = TrainSamples.from_file(
                os.path.join(tmp, f"behaviors_np{cfg.npratio}_0.tsv"),
                corpus.news_index, cfg.replace(user_log_length=length))
    feats = torch.from_numpy(build_news_features(corpus, cfg)).cuda()
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    for name, length, extra in (("fused_tail", 50, {"fused_tail": "on"}),
                                ("fused_tail_l512", 512,
                                 {"fused_tail": "on"}),
                                ("l300", 300, {})):
        tcfg = cfg.replace(compute_dtype="bfloat16", batch_size=128,
                           npratio=4, lr=3e-4, drop_rate=0.2,
                           freeze_embedding=True, device_gather=True,
                           prefetch_depth=2, epochs=1, seed=0,
                           deterministic=False, user_log_length=length,
                           **extra)
        model, state = cs.train_setup(tcfg, table, 2, "cuda")
        step = make_train_step(tcfg, model, device_gather=True)
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(
            samples[length].iter_index_batches(tcfg.batch_size, epoch=0,
                                               seed=2)).items()}
        fa.reset_launch_counts()
        step(state, batch, tcfg.seed, feats)
        torch.cuda.synchronize()
        out[f"step_{name}_launches"] = {
            k: fa.launch_counts(k) for k in (
                "qkv_fwd_probs", "qkv_bwd_probs", "qkv_bwd",
                "fused_tail_fwd", "fused_tail_bwd")}
        out[f"step_{name}"] = cs.profile_device(
            lambda: step(state, batch, tcfg.seed, feats), reps=3)


def main() -> int:
    import torch

    argv = sys.argv[1:]
    save = None
    if "--save" in argv:
        i = argv.index("--save")
        save = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
        os.makedirs(save, exist_ok=True)
    args = [a for a in argv if a not in ("--limits", "--plans")]
    if len(args) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    out = {"label": args[0], "card": torch.cuda.get_device_name(0)}
    bf16, f32 = torch.bfloat16, torch.float32
    from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2

    for n, t, dtype in [(64, 511, bf16), (128, 300, bf16), (7040, 20, bf16),
                        (7040, 20, f32), (128, 50, bf16), (128, 50, f32)]:
        name = f"{str(dtype).split('.')[1]} {n}x{t}"
        resident = t <= 64
        for masked in (False, True):
            qkv, bias, g, mask = _inputs(n, t, dtype, masked, 5)
            _, probs = fa.qkv_fwd_probs(qkv, bias, mask, 20)
            rows = {"row4": lambda: fa.qkv_bwd(qkv, bias, mask, g, 20)}
            if not masked or resident:
                rows["row3"] = lambda: fa.qkv_bwd_probs(qkv, bias, probs, g,
                                                        20)
            if not masked and resident:
                rows["row12"] = lambda: q2.qkv2d_bwd(
                    qkv.view(n * t, -1), bias, probs, g, 20, t)
            for row, fn in rows.items():
                with torch.inference_mode():
                    h = _hash(fn())
                out[f"{row} {name}{'m' if masked else ''}"] = [
                    h, cs.time_ms(fn, 10)]
            if resident:
                out[f"plain {name}{'m' if masked else ''}"] = {
                    "row3": cs.time_ms(lambda: fa.qkv_bwd_probs_reference(
                        qkv, bias, probs, g, 20), 5),
                    "row4": cs.time_ms(lambda: fa.qkv_bwd_reference(
                        qkv, bias, mask, g, 20), 5),
                    "sdpa": cs.time_ms(cs.sdpa_bwd_of_qkv(qkv, bias, mask,
                                                          g, 20), 5)}
    _rows_1_2(cs, out)
    _tail(cs, out, args[0], save)
    _tail_precision(out)
    _steps(cs, out)
    if "--limits" in sys.argv:
        _limits(cs, out)
    if "--plans" in sys.argv:
        _plans(cs, out)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
