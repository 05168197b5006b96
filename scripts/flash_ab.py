#!/usr/bin/env python3
"""One side of an A/B of the key-blocked flash kernels (rows 9-10) on one
NVIDIA GPU: run it from the root of each checkout in turn, in one process
per run, on the same card (parent, change, change, parent) and compare the
lines it prints.

    python3 scripts/flash_ab.py LABEL

It prints one line, ``AB {json}``, with:
  - rows 9-10 (flash_fwd, flash_bwd) in ms, CUDA events over 10 calls, on
    q, k, v cut from one fused projection of 20 heads of 20: at (128, 512)
    unmasked and key-masked and (32, 2048), in bf16 (tensor cores) and
    f32 (CUDA cores, the serving path's dtype and the CLI's default);
  - scaled_dot_product_attention's forward and its backward alone (the
    forward outside the timed window) on the same f32 q, k, v: the
    library yardstick, which the port never calls;
  - "hashes": sha256 prefixes of rows 9-10's outputs on fixed numpy inputs
    (PINNED, the inputs of tests/test_torch_kernel_gpu.py's
    test_flash_keeps_its_pinned_bits): o, m, den and dq, dk, dv in bf16
    and past D = 64 (the wide kernels), m and dq, dk, dv in f32 on CUDA
    cores, so two checkouts can be held equal bit for bit;
  - rows 15-16 (blanes_fwd, blanes_bwd): a hash of their outputs on fixed
    inputs at (7040, 20) and masked (64, 511), f32 and bf16, and their ms;
  - the device ms of one training step with 512-news histories (NRMS at
    its published width, batch 128, 1+4 candidates; a synthetic corpus of
    8,192 news) by chip_smoke.profile_device, in bf16 and in f32 (the
    CLI's default dtype), each with the step's row 9-10 launches and
    their regimes (where the checkout counts them);
  - the device and wall ms of Recommender.score_batch (f32) for 64 users
    with 512-news histories over 300 candidates each, on that corpus.
It uses the checkout's own package and chip_smoke.py, so it runs on older
checkouts too. Without CUDA it exits 1.
"""

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.getcwd())

# (N, T, heads, D, dtype, masked): the bf16 tensor-core kernels, the wide
# kernels past D = 64, and the f32 CUDA-core kernels
PINNED = [(4, 512, 20, 20, "bfloat16", False),
          (4, 512, 20, 20, "bfloat16", True),
          (3, 1000, 4, 20, "bfloat16", True),
          (2, 513, 4, 64, "bfloat16", True),
          (2, 512, 2, 80, "float32", True),
          (2, 512, 2, 80, "bfloat16", True),
          (4, 512, 20, 20, "float32", False),
          (4, 512, 20, 20, "float32", True),
          (3, 1000, 4, 8, "float32", True),
          (2, 513, 2, 64, "float32", True)]


def _hash(x):
    import torch

    bits = x.contiguous().view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def pinned_inputs(n, t, heads, d, dtype, masked):
    """q, k, v (views of one projection), the mask (every third row fully
    masked) or None, g, and the backward's m, den, delta, from a numpy
    seed: the same as tests/test_torch_kernel_gpu.py's _pinned_inputs."""
    import torch

    rng = np.random.default_rng(17)
    hd = heads * d
    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(rng.normal(size=(n, t, 3 * hd)).astype(
        np.float32)).to(tdt).cuda()
    g = torch.from_numpy(rng.normal(size=(n, t, hd)).astype(
        np.float32)).to(tdt).cuda()
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[::3] = 0.0
    stats = [rng.normal(size=(n, t, heads)) * 0.5 + 3.0,
             rng.uniform(50.0, 300.0, size=(n, t, heads)),
             rng.normal(size=(n, t, heads))]
    m, den, delta = (torch.from_numpy(x.astype(np.float32)).cuda()
                     for x in stats)
    q, k, v = torch.split(qkv, hd, dim=-1)
    return (q, k, v, torch.from_numpy(mask).cuda() if masked else None, g,
            m, den, delta)


def pinned_hashes(bw):
    """{case: [hashes]}: the forward's o, m, den (m alone on CUDA cores,
    whose o and den sum in another order than the parent's), then the
    backward's dq, dk, dv from the pinned m, den, delta."""
    out = {}
    for n, t, heads, d, dtype, masked in PINNED:
        q, k, v, mask, g, m, den, delta = pinned_inputs(n, t, heads, d,
                                                        dtype, masked)
        fwd = bw.flash_fwd(q, k, v, mask, heads)
        if dtype == "float32" and d <= 64:
            fwd = fwd[1:2]
        grads = bw.flash_bwd(q, k, v, mask, g, m, den, delta, heads)
        out[f"{n}x{t}x{heads}x{d} {dtype}{' m' if masked else ''}"] = [
            _hash(x) for x in (*fwd, *grads)]
    return out


def _qkv(n, t, dtype, masked, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((n, t, 1200), generator=gen, device="cuda").to(dtype)
    g = torch.randn((n, t, 400), generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[::7] = 0.0
    return qkv, g, mask


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.config import Config
    from newsrecommendation_tpu_torch.data import (
        build_news_features, random_word_embeddings, read_news)
    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.data.prepare import (
        prepare_training_data)
    from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
    from newsrecommendation_tpu_torch.models import nrms
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels
    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    out = {"label": sys.argv[1], "card": torch.cuda.get_device_name(0)}
    for n, t, dtype, masked in [(128, 512, torch.bfloat16, False),
                                (128, 512, torch.bfloat16, True),
                                (32, 2048, torch.bfloat16, False),
                                (128, 512, torch.float32, False),
                                (128, 512, torch.float32, True),
                                (32, 2048, torch.float32, False)]:
        qkv, g, mask = _qkv(n, t, dtype, masked, 5)
        q, k, v = torch.split(qkv, 400, dim=-1)
        o, m, den = bw.flash_fwd(q, k, v, mask, 20)
        delta = bw.delta_of(g, o, 20)
        name = str(dtype).split(".")[1]
        key = f"{n}x{t}{'m' if masked else ''}"
        out[f"flash {name} {key}"] = [
            cs.time_ms(lambda: bw.flash_fwd(q, k, v, mask, 20), 10),
            cs.time_ms(lambda: bw.flash_bwd(q, k, v, mask, g, m, den, delta,
                                            20), 10)]
        if dtype == torch.float32:
            qh, kh, vh = (x.reshape(n, t, 20, 20).transpose(1, 2)
                          for x in (q, k, v))
            am = None if mask is None else mask.bool()[:, None, None, :]
            out[f"sdpa {name} {key}"] = [
                cs.time_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(qh, kh, vh,
                                                        attn_mask=am), 10),
                cs.time_ms(cs.sdpa_bwd(qh, kh, vh, am, g.reshape(
                    n, t, 20, 20).transpose(1, 2)), 10)]
    out["hashes"] = pinned_hashes(bw)
    for dtype in (torch.float32, torch.bfloat16):
        for n, t, masked in [(7040, 20, False), (64, 511, True)]:
            qkv, g, mask = _qkv(n, t, dtype, masked, 7)
            name = str(dtype).split(".")[1]
            out[f"blanes {name} {n}x{t}{'m' if masked else ''}"] = [
                _hash(bl.blanes_fwd(qkv, mask, 20)),
                _hash(bl.blanes_bwd(qkv, mask, g, 20)),
                cs.time_ms(lambda: bl.blanes_fwd(qkv, mask, 20)),
                cs.time_ms(lambda: bl.blanes_bwd(qkv, mask, g, 20))]
    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, num_news=8192, num_users=100,
                        num_impressions=600, title_len=cfg.num_words_title,
                        max_history=600, seed=0)
        prepare_training_data(tmp, 1, cfg.npratio, seed=0)
        corpus = read_news(os.path.join(tmp, "news.tsv"), cfg)
        samples = TrainSamples.from_file(
            os.path.join(tmp, f"behaviors_np{cfg.npratio}_0.tsv"),
            corpus.news_index, cfg.replace(user_log_length=512))
    feats = build_news_features(corpus, cfg)
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    feats_dev = torch.from_numpy(feats).cuda()
    for dtype in ("bfloat16", "float32"):
        tcfg = cfg.replace(compute_dtype=dtype, batch_size=128, npratio=4,
                           lr=3e-4, drop_rate=0.2, freeze_embedding=True,
                           device_gather=True, prefetch_depth=2, epochs=1,
                           seed=0, deterministic=False, user_log_length=512)
        model, state = cs.train_setup(tcfg, table, 2, "cuda")
        step = make_train_step(tcfg, model, device_gather=True)
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(
            samples.iter_index_batches(tcfg.batch_size, epoch=0,
                                       seed=2)).items()}
        fa.reset_launch_counts()
        step(state, batch, tcfg.seed, feats_dev)
        torch.cuda.synchronize()
        suffix = "" if dtype == "bfloat16" else "_f32"
        out["step_launches" + suffix] = {
            k: [fa.launch_counts(k), kernels.regime_counts(k)]
            for k in ("flash_fwd", "flash_bwd")}
        out["step_l512" + suffix] = cs.profile_device(
            lambda: step(state, batch, tcfg.seed, feats_dev), reps=5)
        del model, state, step
    scfg = cfg.replace(user_log_length=512)
    params = nrms.init(scfg, table, seed=0, device="cuda")
    rec = Recommender.from_state(scfg, params, corpus.news_index, feats,
                                 device="cuda")
    rng = np.random.default_rng(11)
    ids = list(corpus.news_index)
    hists = [[ids[j] for j in rng.integers(0, len(ids), 512)]
             for _ in range(64)]
    cands = [[ids[j] for j in rng.choice(len(ids), 300, replace=False)]
             for _ in range(64)]
    fa.reset_launch_counts()
    rec.score_batch(hists, cands)
    out["score_batch_l512_launches"] = [fa.launch_counts("flash_fwd"),
                                        kernels.regime_counts("flash_fwd")]
    out["score_batch_l512"] = cs.profile_device(
        lambda: rec.score_batch(hists, cands), reps=10)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
