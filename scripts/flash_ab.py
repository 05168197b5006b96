#!/usr/bin/env python3
"""One side of an A/B of the key-blocked flash kernels (rows 9-10) on one
NVIDIA GPU: run it from the root of each checkout in turn, in one process
per run, on the same card (parent, change, change, parent) and compare the
lines it prints.

    python3 scripts/flash_ab.py LABEL

It prints one line, ``AB {json}``, with:
  - rows 9-10 (flash_fwd, flash_bwd) in ms, CUDA events over 10 calls,
    at (128, 512) unmasked and key-masked and (32, 2048) in bf16, and
    row 9 at (128, 512) in f32 (the serving path's dtype), on q, k, v cut
    from one fused projection of 20 heads of 20;
  - rows 15-16 (blanes_fwd, blanes_bwd): a hash of their outputs on fixed
    inputs at (7040, 20) and masked (64, 511), f32 and bf16, and their ms,
    so two checkouts can be held equal bit for bit;
  - the device ms of one training step with 512-news histories (the
    smoke's long configuration: NRMS at its published width, bf16, batch
    128, 1+4 candidates; a synthetic corpus of 8,192 news) by
    chip_smoke.profile_device, and the step's row 9-10 launches.
It uses the checkout's own package and chip_smoke.py, so it runs on older
checkouts too. Without CUDA it exits 1.
"""

import hashlib
import json
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())


def _hash(x):
    import torch

    bits = x.contiguous().view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


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
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels
    from newsrecommendation_tpu_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    out = {"label": sys.argv[1], "card": torch.cuda.get_device_name(0)}
    for n, t, dtype, masked, bwd in [(128, 512, torch.bfloat16, False, True),
                                     (128, 512, torch.bfloat16, True, True),
                                     (32, 2048, torch.bfloat16, False, True),
                                     (128, 512, torch.float32, False, False),
                                     (128, 512, torch.float32, True, False)]:
        qkv, g, mask = _qkv(n, t, dtype, masked, 5)
        q, k, v = torch.split(qkv, 400, dim=-1)
        o, m, den = bw.flash_fwd(q, k, v, mask, 20)
        times = [cs.time_ms(lambda: bw.flash_fwd(q, k, v, mask, 20), 10)]
        if bwd:
            delta = bw.delta_of(g, o, 20)
            times.append(cs.time_ms(lambda: bw.flash_bwd(
                q, k, v, mask, g, m, den, delta, 20), 10))
        name = str(dtype).split(".")[1]
        out[f"flash {name} {n}x{t}{'m' if masked else ''}"] = times
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
    tcfg = cfg.replace(compute_dtype="bfloat16", batch_size=128, npratio=4,
                       lr=3e-4, drop_rate=0.2, freeze_embedding=True,
                       device_gather=True, prefetch_depth=2, epochs=1,
                       seed=0, deterministic=False, user_log_length=512)
    model, state = cs.train_setup(tcfg, table, 2, "cuda")
    step = make_train_step(tcfg, model, device_gather=True)
    feats_dev = torch.from_numpy(feats).cuda()
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        samples.iter_index_batches(tcfg.batch_size, epoch=0,
                                   seed=2)).items()}
    fa.reset_launch_counts()
    step(state, batch, tcfg.seed, feats_dev)
    torch.cuda.synchronize()
    out["step_launches"] = {k: fa.launch_counts(k)
                            for k in ("flash_fwd", "flash_bwd")}
    out["step_l512"] = cs.profile_device(
        lambda: step(state, batch, tcfg.seed, feats_dev), reps=5)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
