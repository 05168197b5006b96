"""Shared model pieces: title-embedding lookup (both input formats), the
user-history pad-doc path, and the training objective."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def default_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Dense embedding-row gather."""
    return table[ids.long()]


def frozen_table(table: torch.Tensor, cfg) -> torch.Tensor:
    """Prepare the embedding table for lookup: freeze + compute-dtype cast.

    The cast to cfg.compute_dtype happens BEFORE the gather: converting the
    (V, D) table once is cheaper than converting every gathered row, and a
    bf16 gather moves half the bytes. On a mesh with table shards the
    table is the rank's shard, and only that is cast.
    """
    if cfg.freeze_embedding:
        table = table.detach()  # no gradient, not even a zero one
    return table.to(getattr(torch, cfg.compute_dtype))


def title_word_vecs(table, features, cfg, lookup=default_lookup):
    """Per-token word vectors for each news item.

    features: (..., F) int feature rows (title columns first).
    Returns (..., num_words_title, word_embedding_dim). The multiply by
    (id != 0) gives padding_idx=0 semantics: row 0 reads as an exact zero.
    """
    if cfg.title_source == "word_ids":
        ids = features[..., : cfg.num_words_title]  # (..., T)
        return lookup(table, ids) * (ids != 0)[..., None].to(table.dtype)
    # doc_table: one pointer column into a (num_news+1, T*D) flattened table
    ptr = features[..., 0]
    flat = lookup(table, ptr) * (ptr != 0)[..., None].to(table.dtype)
    return flat.reshape(*ptr.shape, cfg.num_words_title,
                        cfg.word_embedding_dim)


def apply_pad_doc(news_vecs, log_mask, pad_doc):
    """Replace masked history slots with the learned pad document (the
    user_log_mask=False path: attention then runs unmasked)."""
    m = log_mask[..., None].to(news_vecs.dtype)
    return news_vecs * m + pad_doc.to(news_vecs.dtype) * (1.0 - m)


def slot_cross_entropy(scores, labels, weights=None):
    """Softmax cross entropy over the 1+K candidate slots, in f32.

    weights: optional (B,) 0/1 per-sample weights for a padded final batch;
    the weighted mean divides by max(sum(w), 1), so an all-padding batch
    gives 0 rather than NaN.
    """
    ce = F.cross_entropy(scores.float(), labels.long(), reduction="none")
    if weights is None:
        return ce.mean()
    w = weights.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)
