"""Two-phase evaluation.

Phase 1, the whole-corpus news-vector cache: the news encoder runs over
the combined feature matrix in chunks of cfg.eval_news_chunk rows; the
(num_news+1, news_dim) cache stays on the device (serving reads it too).

Phase 2, impression scoring: for each fixed-shape batch of padded
impressions, the history vectors are gathered from the cache, the user
encoder runs, the candidates are gathered and scored, and every ranking
metric is summed on the device (metrics.impression_metrics); only the
sums come back to the host, folded into float64 every 64 batches. The
eval step reads params["user_encoder"] only.

The doc-sim probe (mean cosine similarity over random news pairs, a
collapse detector, reference main.py:201-208) draws its pairs as the JAX
package's does.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from newsrecommendation_tpu_torch.metrics import impression_metrics
from newsrecommendation_tpu_torch.ops.scoring import score_cached_impressions
from newsrecommendation_tpu_torch.train.prefetch import stage_ahead

METRIC_KEYS = ("auc", "mrr", "ndcg5", "ndcg10", "count")
_FOLD_EVERY = 64  # batches between folds of the device sums into float64


@torch.inference_mode()
def compute_news_scoring(model, params, cfg, news_features: np.ndarray,
                         encode_fn=None) -> torch.Tensor:
    """Encode the whole corpus -> (num_news+1, news_dim) cache on the
    params' device.

    The feature matrix crosses to the device once; each chunk is a slice of
    it. Row 0 is the unknown-news vector: the reference computes it from
    the zero feature row (not forced to zero), so it is kept as encoded.
    encode_fn(params, features): the encoder to run (default
    model.news_encoder); parallel/spmd.py:make_spmd_news_encoder's on a
    row-sharded table, which every rank of a table group runs over the
    same chunks.
    """
    if encode_fn is None:
        def encode_fn(p, f):
            return model.news_encoder(p, cfg, f)
    device = params["embedding_table"].device
    feats = torch.from_numpy(np.ascontiguousarray(news_features)).to(device)
    n = feats.shape[0]
    chunk = max(min(cfg.eval_news_chunk, n), 1)
    outs = [encode_fn(params, feats[start:start + chunk])
            for start in range(0, n, chunk)]
    return torch.cat(outs, dim=0)


@torch.inference_mode()
def doc_sim_probe(news_scoring, num_pairs: int = 1_000_000,
                  seed: int = 0) -> float:
    """Mean cosine similarity over random news-vector pairs (rows >= 1),
    on the cache's device. A collapsed news encoder drives it toward 1.
    Pairs with i == j count as 0 but still divide the mean, as in the
    reference."""
    vecs = torch.as_tensor(news_scoring)
    n = vecs.shape[0]
    if n <= 2:
        return float("nan")
    rng = np.random.default_rng(seed)
    i = rng.integers(1, n, size=num_pairs)
    j = rng.integers(1, n, size=num_pairs)
    keep = (i != j).astype(np.float32)
    total = 0.0
    step = 262144  # bounds the device memory of the gathered pairs
    for s in range(0, num_pairs, step):
        ii, jj, kk = (torch.from_numpy(x[s:s + step]).to(vecs.device)
                      for x in (i, j, keep))
        a, b = vecs[ii].float(), vecs[jj].float()
        den = torch.clamp(a.norm(dim=-1) * b.norm(dim=-1), min=1e-12)
        total += float(torch.sum((a * b).sum(-1) / den * kk))
    return total / num_pairs


def _eval_metrics_body(model, cfg, params, news_scoring, batch):
    params = {"user_encoder": params["user_encoder"]}  # the contract
    hist_vecs = news_scoring[batch["history"].long()]
    user_vecs = model.user_encoder(params, cfg, hist_vecs,
                                   batch["history_mask"])
    scores = score_cached_impressions(news_scoring,
                                      batch["candidates"].long(), user_vecs)
    return impression_metrics(scores, batch["labels"],
                              batch["candidate_mask"])


def make_eval_step(model, cfg):
    """eval_step(params, news_scoring, batch) -> metric sums of one batch.

    CONTRACT: it reads params["user_encoder"] only. Phase 2 scores from the
    news cache, never the embedding table or the news encoder; a model
    whose user path needs more must extend this path, not read more here.
    """
    @torch.inference_mode()
    def eval_step(params, news_scoring, batch):
        return _eval_metrics_body(model, cfg, params, news_scoring, batch)

    return eval_step


def make_eval_step_acc(model, cfg):
    """eval_step_acc(params, news_scoring, batch, sums) -> sums with the
    batch's added, on the device (no host sync). Same contract."""
    @torch.inference_mode()
    def eval_step_acc(params, news_scoring, batch, sums):
        out = _eval_metrics_body(model, cfg, params, news_scoring, batch)
        return {k: sums[k] + out[k] for k in sums}

    return eval_step_acc


def make_eval_multi_step_acc(model, cfg, k: int):
    """k stacked eval batches per call (every tensor with a leading axis
    of k), run back to back with the sums carried on the device: the same
    sums as k calls of make_eval_step_acc. Same contract."""
    step = make_eval_step_acc(model, cfg)

    def eval_multi_acc(params, news_scoring, stacked, sums):
        for j in range(k):
            sums = step(params, news_scoring,
                        {key: v[j] for key, v in stacked.items()}, sums)
        return sums

    return eval_multi_acc


def combine_metric_sums(per_shard_sums) -> Dict[str, float]:
    """Sum metric-sum dicts from several eval shards into one (the
    reference's dist.reduce(SUM), main.py:269-275)."""
    total: Dict[str, float] = {}
    for sums in per_shard_sums:
        for k, v in sums.items():
            total[k] = total.get(k, 0.0) + float(v)
    return total


def cross_process_sum(sums: Dict[str, float]) -> Dict[str, float]:
    """Metric sums over every process of a run: each evaluates its own
    behaviors_{rank}.tsv shard, and one all-reduce (SUM, float64) over the
    world adds them up on every rank (the reference's dist.reduce to rank
    0, main.py:269-275, with the result on every rank). The identity
    without a process group of several ranks."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return dict(sums)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    keys = sorted(sums)
    total = torch.tensor([float(sums[k]) for k in keys],
                         dtype=torch.float64, device=device)
    dist.all_reduce(total)
    return dict(zip(keys, total.cpu().tolist()))


def summarize_metric_sums(sums: Dict[str, float],
                          samples_seen: float) -> Dict[str, float]:
    """Weighted means from metric sums, with the count of valid
    impressions and of impressions seen."""
    sums = dict(sums)
    count = max(sums.pop("count"), 1.0)
    result = {k: v / count for k, v in sums.items()}
    result["count"] = count
    result["samples_seen"] = float(samples_seen)
    return result


def _to_device(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def evaluate_impressions(model, params, cfg, eval_samples, news_scoring,
                         log_every: Optional[int] = None,
                         return_sums: bool = False) -> Dict[str, float]:
    """Phase 2 over ``eval_samples`` on the cache's device; returns the
    mean metrics (auc, mrr, ndcg5, ndcg10), the count of valid impressions
    and samples_seen.

    Padded batch rows have no real candidate, and real impressions with
    all-0 or all-1 labels none of one kind, so the valid-impression mask
    drops both (reference main.py:250-251). Batches are built and copied
    to the device on a worker thread (stage_ahead), cfg.eval_steps_per_call
    at a time; the sums stay on the device and are folded into float64 on
    the host every 64 calls and at log points, which bounds the float32
    drift of the running sums. return_sums=True returns the raw sums (and
    samples_seen) instead of means.
    """
    news_scoring = torch.as_tensor(news_scoring)
    device = news_scoring.device
    eval_step_acc = make_eval_step_acc(model, cfg)
    kk = max(1, int(cfg.eval_steps_per_call))
    eval_multi_acc = (make_eval_multi_step_acc(model, cfg, kk)
                      if kk > 1 else None)

    def zeros():
        return {k: torch.zeros((), device=device) for k in METRIC_KEYS}

    sums_host = {k: 0.0 for k in METRIC_KEYS}  # float64
    sums_dev = zeros()
    seen = 0

    def fold():
        nonlocal sums_dev
        for k in METRIC_KEYS:
            sums_host[k] += float(sums_dev[k])  # waits for the device
        sums_dev = zeros()

    def grouped():
        pending = []
        for batch in eval_samples.iter_batches(cfg.eval_batch_size):
            if kk == 1:
                yield "single", [batch]
                continue
            pending.append(batch)
            if len(pending) == kk:
                yield "stack", pending
                pending = []
        for batch in pending:  # fewer than kk left: one at a time
            yield "single", [batch]

    def stage(item):
        kind, batches = item
        num_real = sum(b["num_real"] for b in batches)
        keys = [k for k in batches[0] if k != "num_real"]
        if kind == "stack":
            host = {k: np.stack([b[k] for b in batches]) for k in keys}
        else:
            host = {k: batches[0][k] for k in keys}
        return kind, _to_device(host, device), num_real

    staged = stage_ahead(grouped(), stage, depth=cfg.prefetch_depth)
    for cnt, (kind, dev_batch, num_real) in enumerate(staged):
        if kind == "stack":
            sums_dev = eval_multi_acc(params, news_scoring, dev_batch,
                                      sums_dev)
        else:
            sums_dev = eval_step_acc(params, news_scoring, dev_batch,
                                     sums_dev)
        seen += num_real
        if (cnt + 1) % _FOLD_EVERY == 0:
            fold()
        if log_every and cnt % log_every == 0:
            fold()
            c = max(sums_host["count"], 1.0)
            logging.info(
                "[eval] %d samples: AUC %.2f MRR %.2f nDCG5 %.2f nDCG10 %.2f",
                seen, 100 * sums_host["auc"] / c, 100 * sums_host["mrr"] / c,
                100 * sums_host["ndcg5"] / c, 100 * sums_host["ndcg10"] / c)
    fold()
    sums = dict(sums_host)
    if return_sums:
        sums["samples_seen"] = float(seen)
        return sums
    sums = cross_process_sum(dict(sums, samples_seen=float(seen)))
    seen = sums.pop("samples_seen")
    return summarize_metric_sums(sums, seen)
