"""NRMS: multi-head self-attention news encoder + MHSA user encoder.

Reference model/NRMS.py: the news encoder runs word embedding -> dropout ->
MHSA -> dropout -> additive attention pooling; the user encoder runs MHSA
over the history + pooling, with the learned pad-doc substitution when
user_log_mask=False. Plain functions over a param dict of tensors, laid
out as the JAX package's param pytree (bridge.py converts between them).
"""

from __future__ import annotations

import torch

from newsrecommendation_tpu_torch.models import common
from newsrecommendation_tpu_torch.ops import (
    dropout,
    init_attention_pooling,
    init_multi_head_self_attention,
    mhsa_dropout_pool,
)
from newsrecommendation_tpu_torch.ops.scoring import score_candidates
from newsrecommendation_tpu_torch.utils import init as pinit
from newsrecommendation_tpu_torch.utils import resolve_device, to_device


def init(cfg, embedding_table, *, num_category: int = 0,
         num_subcategory: int = 0, seed: int = 0, device="cuda"):
    """Build the NRMS param dict on ``device`` (raises if it is "cuda" and
    CUDA is missing). num_category and num_subcategory are taken and
    ignored, so every model's init has NAML's signature.

    embedding_table: (V+1, word_dim) word table for title_source="word_ids",
    or the flattened per-title table (num_news+1, T*word_dim) for
    "doc_table". Row 0 must be zero. The weights are drawn on the CPU from
    a torch.Generator seeded with ``seed``, then moved.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.dim_per_head
    params = {
        # a copy: training updates params in place
        "embedding_table": torch.as_tensor(embedding_table,
                                           dtype=torch.float32).clone(),
        "news_encoder": {
            "mhsa": init_multi_head_self_attention(
                gen, cfg.word_embedding_dim, cfg.num_attention_heads, d),
            "attn": init_attention_pooling(
                gen, cfg.news_dim, cfg.news_query_vector_dim),
        },
        "user_encoder": {
            "mhsa": init_multi_head_self_attention(
                gen, cfg.news_dim, cfg.num_attention_heads, d),
            "attn": init_attention_pooling(
                gen, cfg.news_dim, cfg.user_query_vector_dim),
            "pad_doc": pinit.uniform(gen, (cfg.news_dim,), 1.0),
        },
    }
    return to_device(params, dev)


def news_encoder(params, cfg, features, mask=None, *, generator=None,
                 deterministic=True, lookup=common.default_lookup):
    """features: (B, F) int -> news vectors (B, news_dim)."""
    p = params["news_encoder"]
    word_vecs = common.title_word_vecs(
        common.frozen_table(params["embedding_table"], cfg), features, cfg,
        lookup)
    word_vecs = dropout(word_vecs, cfg.drop_rate, deterministic, generator)
    return mhsa_dropout_pool(
        p["mhsa"], p["attn"], word_vecs, mask,
        n_heads=cfg.num_attention_heads, drop_rate=cfg.drop_rate,
        generator=generator, deterministic=deterministic)


def user_encoder(params, cfg, news_vecs, log_mask):
    """news_vecs: (B, L, news_dim), log_mask: (B, L) -> user vec (B, news_dim)."""
    p = params["user_encoder"]
    if cfg.user_log_mask:
        return mhsa_dropout_pool(p["mhsa"], p["attn"], news_vecs, log_mask,
                                 n_heads=cfg.num_attention_heads)
    padded = common.apply_pad_doc(news_vecs, log_mask, p["pad_doc"])
    return mhsa_dropout_pool(p["mhsa"], p["attn"], padded, None,
                             n_heads=cfg.num_attention_heads)


def forward(params, cfg, batch, *, generator=None, deterministic=True,
            lookup=common.default_lookup):
    """Training forward: (loss, scores).

    batch: history (B,L,F) int, history_mask (B,L) f32, candidate
    (B,1+K,F) int, label (B,) int, optional weight (B,) f32. Candidates and
    history are encoded in one news-encoder call, as in the JAX package.
    deterministic=False applies the news encoder's two dropouts, drawing
    from ``generator`` (on the batch's device; None: torch's default).
    lookup: the title-table gather (the row-sharded one on a mesh with
    table shards, parallel/spmd.py:table_lookup).
    """
    b, n_slots, feat = batch["candidate"].shape
    n_cand = b * n_slots
    all_flat = torch.cat([batch["candidate"].reshape(-1, feat),
                          batch["history"].reshape(-1, feat)], dim=0)
    all_vecs = news_encoder(params, cfg, all_flat, generator=generator,
                            deterministic=deterministic, lookup=lookup)
    cand_vecs = all_vecs[:n_cand].reshape(b, n_slots, cfg.news_dim)
    hist_vecs = all_vecs[n_cand:].reshape(b, cfg.user_log_length,
                                          cfg.news_dim)
    user_vec = user_encoder(params, cfg, hist_vecs, batch["history_mask"])
    scores = score_candidates(cand_vecs, user_vec)
    loss = common.slot_cross_entropy(scores, batch["label"],
                                     batch.get("weight"))
    return loss, scores
