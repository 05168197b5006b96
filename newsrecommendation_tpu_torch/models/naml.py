"""NAML: CNN title encoder + category/subcategory views fused by additive
attention; attention-pooling user encoder.

Reference model/NAML.py, as the JAX package computes it: the title view
runs word embedding -> dropout -> Conv1d(k=3, word_dim -> news_dim, SAME)
-> attention pooling; each category view is Embedding(+1, category_emb_dim,
padding_idx=0) + Linear -> news_dim; the views are stacked and pooled by a
second attention pooling; the user encoder is attention pooling only, with
the learned pad-doc substitution when user_log_mask=False. No attention
kernel runs on this path: the CNN is one matrix product (ops/conv.py).
Plain functions over a param dict laid out as the JAX package's pytree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from newsrecommendation_tpu_torch.models import common
from newsrecommendation_tpu_torch.ops import (
    attention_pooling,
    conv1d_same,
    dropout,
    init_attention_pooling,
    init_conv1d,
    linear,
)
from newsrecommendation_tpu_torch.ops.scoring import score_candidates
from newsrecommendation_tpu_torch.utils import init as pinit
from newsrecommendation_tpu_torch.utils import resolve_device, to_device


def init(cfg, embedding_table, *, num_category: int = 0,
         num_subcategory: int = 0, seed: int = 0, device="cuda"):
    """Build the NAML param dict on ``device`` (raises if it is "cuda" and
    CUDA is missing); embedding_table and the seeded draws as in
    nrms.init. The category (subcategory) table has num_category + 1
    (num_subcategory + 1) rows, row 0 zero; ``final_attn`` exists only
    when a category view is on."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        # a copy: training updates params in place
        "embedding_table": torch.as_tensor(embedding_table,
                                           dtype=torch.float32).clone(),
        "news_encoder": {
            "cnn": init_conv1d(gen, cfg.word_embedding_dim, cfg.news_dim, 3),
            "attn": init_attention_pooling(
                gen, cfg.news_dim, cfg.news_query_vector_dim),
        },
        "user_encoder": {
            "attn": init_attention_pooling(
                gen, cfg.news_dim, cfg.user_query_vector_dim),
            "pad_doc": pinit.uniform(gen, (cfg.news_dim,), 1.0),
        },
    }
    ne = params["news_encoder"]
    if cfg.use_category:
        ne["category_emb"] = pinit.embedding(gen, num_category + 1,
                                             cfg.category_emb_dim)
        ne["category_dense"] = pinit.torch_linear(
            gen, cfg.category_emb_dim, cfg.news_dim)
    if cfg.use_subcategory:
        ne["subcategory_emb"] = pinit.embedding(gen, num_subcategory + 1,
                                                cfg.category_emb_dim)
        ne["subcategory_dense"] = pinit.torch_linear(
            gen, cfg.category_emb_dim, cfg.news_dim)
    if cfg.use_category or cfg.use_subcategory:
        ne["final_attn"] = init_attention_pooling(
            gen, cfg.news_dim, cfg.news_query_vector_dim)
    return to_device(params, dev)


def _category_view(emb_table, dense, ids):
    """Embedding(padding_idx=0) + Linear: row 0 reads as zero, and the
    bias is added for it too (NAML.py:60-68).

    F.embedding, not indexing: a step looks up thousands of ids in a table
    of a few rows, and the backward of an index (indexing_backward_kernel)
    sums each row's duplicates serially: 1.8 ms of the NAML benchmark
    step's 7.6 device ms (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W),
    where embedding's backward splits them."""
    vec = F.embedding(ids.long(), emb_table)
    vec = vec * (ids != 0)[..., None].to(vec.dtype)
    return linear(dense, vec)


def news_encoder(params, cfg, features, mask=None, *, generator=None,
                 deterministic=True, lookup=common.default_lookup):
    """features: (B, F) int -> news vectors (B, news_dim).

    Feature columns: the title (num_words_title word ids, or one doc
    pointer), then category, then subcategory. With a category view the
    result is f32 (the views' params are, as in the JAX package); without
    one it has the compute dtype."""
    p = params["news_encoder"]
    title_w = cfg.num_words_title if cfg.title_source == "word_ids" else 1
    word_vecs = common.title_word_vecs(
        common.frozen_table(params["embedding_table"], cfg), features, cfg,
        lookup)
    word_vecs = dropout(word_vecs, cfg.drop_rate, deterministic, generator)
    ctx = conv1d_same(p["cnn"], word_vecs)  # (B, T, news_dim)
    views = [attention_pooling(p["attn"], ctx, mask)]
    col = title_w
    if cfg.use_category:
        views.append(_category_view(p["category_emb"], p["category_dense"],
                                    features[..., col]))
        col += 1
    if cfg.use_subcategory:
        views.append(_category_view(p["subcategory_emb"],
                                    p["subcategory_dense"],
                                    features[..., col]))
    if len(views) == 1:
        return views[0]
    stacked = torch.stack(views, dim=-2)  # (B, V, news_dim), promoted
    return attention_pooling(p["final_attn"], stacked, None)


def user_encoder(params, cfg, news_vecs, log_mask):
    """news_vecs: (B, L, news_dim), log_mask: (B, L) -> user vec
    (B, news_dim): attention pooling only, no user-level MHSA."""
    p = params["user_encoder"]
    if cfg.user_log_mask:
        return attention_pooling(p["attn"], news_vecs, log_mask)
    padded = common.apply_pad_doc(news_vecs, log_mask, p["pad_doc"])
    return attention_pooling(p["attn"], padded, None)


def forward(params, cfg, batch, *, generator=None, deterministic=True,
            lookup=common.default_lookup):
    """Training forward: (loss, scores); the batch and the dropout draws
    as in nrms.forward, candidates and history in one news-encoder call;
    lookup as in nrms.forward."""
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
