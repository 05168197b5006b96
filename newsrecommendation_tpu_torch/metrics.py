"""Ranking metrics: numpy per-impression oracles and batched, mask-aware
PyTorch versions that run on the scores' device.

The numpy oracles are the JAX package's (newsrecommendation_tpu/
metrics.py:33-95, the reference's metrics.py semantics; AUC tie-averaged
as sklearn's). The batched versions score whole eval batches of padded
impressions at once, so only the metric sums leave the device.

Conventions for the batched versions:
  scores : (B, C) float — candidate scores, padded entries arbitrary
  labels : (B, C) float — 0/1 relevance, padded entries must be 0
  mask   : (B, C) float — 1 for real candidates, 0 for padding
Degenerate impressions (all-0 or all-1 labels) are the caller's to drop,
as the reference does (main.py:250-251): ``valid_impression_mask``.
Every sort is stable, so the order within a tie never reaches a result.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NEG_INF = -1e30

# --------------------------------------------------------------------------
# numpy oracles (reference metrics.py semantics)
# --------------------------------------------------------------------------


def _rankdata_average(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with tie averaging, like scipy.rankdata."""
    sorter = np.argsort(x, kind="mergesort")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(x))
    xs = x[sorter]
    obs = np.r_[True, xs[1:] != xs[:-1]]
    dense = obs.cumsum()[inv]
    # count[i] = number of elements <= the i-th distinct value
    count = np.r_[np.nonzero(obs)[0], len(obs)]
    return 0.5 * (count[dense] + count[dense - 1] + 1)


def roc_auc_score(y_true, y_score) -> float:
    """Binary AUC with tie averaging; matches sklearn.roc_auc_score."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    npos = y_true.sum()
    nneg = len(y_true) - npos
    if npos == 0 or nneg == 0:
        raise ValueError("AUC undefined for single-class labels")
    ranks = _rankdata_average(y_score)
    return float((ranks[y_true == 1].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


def dcg_score(y_true, y_score, k: int = 10) -> float:
    """DCG@k with 2**rel - 1 gains (reference metrics.py:5-10)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    order = np.argsort(np.asarray(y_score))[::-1]
    taken = np.take(y_true, order[:k])
    gains = 2**taken - 1
    discounts = np.log2(np.arange(len(taken)) + 2)
    return float(np.sum(gains / discounts))


def ndcg_score(y_true, y_score, k: int = 10) -> float:
    """nDCG@k (reference metrics.py:13-16)."""
    best = dcg_score(y_true, y_true, k)
    actual = dcg_score(y_true, y_score, k)
    return actual / best


def mrr_score(y_true, y_score) -> float:
    """Mean reciprocal rank over all positives (reference metrics.py:19-23)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    order = np.argsort(np.asarray(y_score))[::-1]
    taken = np.take(y_true, order)
    rr = taken / (np.arange(len(taken)) + 1)
    return float(np.sum(rr) / np.sum(y_true))


def ctr_score(y_true, y_score, k: int = 1) -> float:
    """Mean relevance of the top-k (reference metrics.py:26-29)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    order = np.argsort(np.asarray(y_score))[::-1]
    return float(np.mean(np.take(y_true, order[:k])))


# --------------------------------------------------------------------------
# batched PyTorch versions (mask-aware, on the scores' device)
# --------------------------------------------------------------------------


def valid_impression_mask(labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """(B,) 1.0 where an impression has both a positive and a negative
    among its real candidates (reference main.py:250-251)."""
    npos = torch.sum(labels * mask, dim=-1)
    nreal = torch.sum(mask, dim=-1)
    return ((npos > 0) & (npos < nreal)).float()


def _tie_bounds(xs: torch.Tensor):
    """For each position k of a sorted last axis: the first and last
    position of its tie group (a cummax of group starts carried forward,
    a cummin of group ends carried backward)."""
    c = xs.shape[-1]
    idx = torch.arange(c, device=xs.device).expand_as(xs)
    edge = torch.ones(xs.shape[:-1] + (1,), dtype=torch.bool,
                      device=xs.device)
    new_group = torch.cat([edge, xs[..., 1:] != xs[..., :-1]], dim=-1)
    first = torch.cummax(torch.where(new_group, idx, 0), dim=-1).values
    last_of_group = torch.cat([new_group[..., 1:], edge], dim=-1)
    last = torch.where(last_of_group, idx, c - 1).flip(-1)
    last = torch.cummin(last, dim=-1).values.flip(-1)
    return first, last


def batched_rankdata_average(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Tie-averaged 1-based ranks along ``dim`` (batched scipy.rankdata):
    the element at sorted position k has rank (first(k) + last(k))/2 + 1
    over its tie group, scattered back through the inverse permutation."""
    x = x.movedim(dim, -1)
    xs, order = torch.sort(x, dim=-1, stable=True)
    first, last = _tie_bounds(xs)
    avg_sorted = 0.5 * (first + last).float() + 1.0
    ranks = torch.empty_like(avg_sorted).scatter_(-1, order, avg_sorted)
    return ranks.movedim(-1, dim)


def _desc_sort(scores, labels, mask):
    """Real scores sorted descending (padding at -1e30, last) and the
    labels in that order (0 on padding)."""
    masked = torch.where(mask > 0, scores.float(), _NEG_INF)
    xs, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    return xs, torch.gather(labels.float() * mask, -1, order)


def batched_auc(scores, labels, mask) -> torch.Tensor:
    """(B,) AUC per impression from tie-averaged ranks, O(C log C).

    AUC = (sum of positive ranks - npos(npos+1)/2) / (npos nneg), ranks
    tie-averaged among real candidates, read off the descending sort: an
    ascending rank is C+1 minus the descending one, padding (-1e30, one
    tie group at the bottom) re-based away by subtracting its count. Ranks
    and rank sums stay below 2^24, so float32 is exact. Degenerate
    impressions give 0 (drop them with valid_impression_mask).
    """
    labels = labels.float() * mask
    c = scores.shape[-1]
    xs, sorted_labels = _desc_sort(scores, labels, mask)
    first, last = _tie_bounds(xs)
    asc_ranks = (c + 1.0) - (0.5 * (first + last).float() + 1.0)
    npad = torch.sum(1.0 - mask, dim=-1)
    npos = torch.sum(labels, dim=-1)
    nneg = torch.sum(mask, dim=-1) - npos
    pos_rank_sum = torch.sum((asc_ranks - npad[..., None]) * sorted_labels,
                             dim=-1)
    num = pos_rank_sum - npos * (npos + 1.0) * 0.5
    den = npos * nneg
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.zeros_like(num))


def _sorted_labels(scores, labels, mask):
    return _desc_sort(scores, labels, mask)[1]


def batched_dcg(scores, labels, mask, k: int = 10) -> torch.Tensor:
    taken = _sorted_labels(scores, labels, mask)[..., :k]
    positions = torch.arange(taken.shape[-1], dtype=torch.float32,
                             device=taken.device)
    discounts = 1.0 / torch.log2(positions + 2.0)
    gains = torch.pow(2.0, taken) - 1.0
    return torch.sum(gains * discounts, dim=-1)


def batched_ndcg(scores, labels, mask, k: int = 10) -> torch.Tensor:
    """(B,) nDCG@k; the best DCG sorts labels by themselves
    (metrics.py:13-16)."""
    labels = labels.float()
    best = batched_dcg(labels, labels, mask, k)
    actual = batched_dcg(scores, labels, mask, k)
    return torch.where(best > 0, actual / torch.clamp(best, min=1e-12),
                       torch.zeros_like(best))


def batched_mrr(scores, labels, mask) -> torch.Tensor:
    """(B,) MRR over all positives (metrics.py:19-23)."""
    labels = labels.float()
    taken = _sorted_labels(scores, labels, mask)
    positions = torch.arange(taken.shape[-1], dtype=torch.float32,
                             device=taken.device)
    rr = taken / (positions + 1.0)
    npos = torch.sum(labels * mask, dim=-1)
    return torch.where(npos > 0,
                       torch.sum(rr, dim=-1) / torch.clamp(npos, min=1.0),
                       torch.zeros_like(npos))


def batched_ctr(scores, labels, mask, k: int = 1) -> torch.Tensor:
    """(B,) mean top-k relevance (metrics.py:26-29)."""
    return torch.mean(_sorted_labels(scores, labels, mask)[..., :k], dim=-1)


def impression_metrics(scores, labels, mask) -> Dict[str, torch.Tensor]:
    """The eval metrics of a batch of padded impressions, summed over its
    valid impressions, and their count: device scalars, ready to be
    added up over batches and divided by the count."""
    valid = valid_impression_mask(labels, mask)
    out = {
        "auc": batched_auc(scores, labels, mask),
        "mrr": batched_mrr(scores, labels, mask),
        "ndcg5": batched_ndcg(scores, labels, mask, k=5),
        "ndcg10": batched_ndcg(scores, labels, mask, k=10),
    }
    sums = {name: torch.sum(v * valid) for name, v in out.items()}
    sums["count"] = torch.sum(valid)
    return sums


def train_accuracy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Argmax accuracy over the (1+K)-way slots (reference utils.py:36-40)."""
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())
