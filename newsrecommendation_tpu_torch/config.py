"""Frozen dataclass configuration for the PyTorch port.

The fields NRMS serving and training read, under the JAX package's names
and with its defaults, so one set of keyword arguments builds a config for
either side. Fields of slices not yet ported (checkpoints and the CLI's
settings, eval, NAML, sharding) are left out until those slices land.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- model family ------------------------------------------------------
    model: str = "NRMS"  # registry key; only "NRMS" is ported
    # "word_ids": (num_news+1, num_words_title) word ids into a word table;
    # "doc_table": one doc-index column into a frozen per-title table of
    # shape (num_news+1, num_words_title*word_embedding_dim).
    title_source: str = "word_ids"

    # ---- model dims --------------------------------------------------------
    num_words_title: int = 20
    user_log_length: int = 50
    word_embedding_dim: int = 300
    news_dim: int = 400
    news_query_vector_dim: int = 200
    user_query_vector_dim: int = 200
    num_attention_heads: int = 20
    use_category: bool = False
    use_subcategory: bool = False
    user_log_mask: bool = False
    drop_rate: float = 0.2
    freeze_embedding: bool = False

    # ---- training ----------------------------------------------------------
    batch_size: int = 32
    npratio: int = 4  # negatives per positive: 1+npratio candidate slots
    epochs: int = 1
    lr: float = 1e-4
    seed: int = 0  # data order, positive slots and dropout draws
    start_epoch: int = 0
    log_steps: int = 100
    save_steps: int = 10000
    steps_per_call: int = 1  # k>1: k optimizer steps per make_multi_step call
    # Host batches staged ahead of the step by a background thread
    # (train/prefetch.py). 0: inline, no thread.
    prefetch_depth: int = 2
    # Keep the news-feature matrix on the device and gather rows in the
    # step; the host ships only (B, L) int32 news indices per step.
    device_gather: bool = True
    deterministic: bool = False  # dropout off everywhere
    profile_dir: Optional[str] = None  # torch.profiler trace output dir

    # ---- data --------------------------------------------------------------
    filter_num: int = 3  # min word count for the word vocab
    tokenizer: str = "treebank"  # "treebank" | "regex"

    # ---- execution ---------------------------------------------------------
    compute_dtype: str = "float32"  # "float32" | "bfloat16" activations
    # What the attention forward saves for its backward: "probs" (the f32
    # attention probs; kernel rows 2-3) or "recompute" (nothing; the
    # backward recomputes them, rows 1 and 4). Same gradients.
    bwd_residuals: str = "probs"
    # "on": each NRMS encoder tail (MHSA -> dropout -> pooling) runs as one
    # kernel (rows 13-14); "auto" and "off" compose it from rows 1-4.
    fused_tail: str = "auto"  # "auto" | "on" | "off"
    attention_layout: str = "headloop"  # "headloop" | "blanes"
    eval_news_chunk: int = 1024  # corpus rows per news-encoder call
    # Recommender's "auto" scorer: dense (whole-corpus matmul) while the
    # cache has at most this many rows, gather (candidate rows only) above.
    serve_dense_max_rows: int = 524288

    def __post_init__(self):
        if self.model not in ("NRMS", "NAML"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.title_source not in ("word_ids", "doc_table"):
            raise ValueError(f"unknown title_source {self.title_source!r}")
        if self.news_dim % self.num_attention_heads != 0:
            raise ValueError(
                f"news_dim {self.news_dim} not divisible by "
                f"num_attention_heads {self.num_attention_heads}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.fused_tail not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_tail {self.fused_tail!r}")
        if self.attention_layout not in ("headloop", "blanes"):
            raise ValueError(
                f"unknown attention_layout {self.attention_layout!r}")
        if self.bwd_residuals not in ("recompute", "probs"):
            raise ValueError(
                f"unknown bwd_residuals {self.bwd_residuals!r}")
        if self.tokenizer not in ("treebank", "regex"):
            raise ValueError(f"unknown tokenizer {self.tokenizer!r}")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, "
                             f"got {self.steps_per_call}")
        if self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, "
                             f"got {self.prefetch_depth}")

    @property
    def dim_per_head(self) -> int:
        return self.news_dim // self.num_attention_heads

    @property
    def news_feature_width(self) -> int:
        """Width of one row of the combined news-feature matrix: the title
        columns (num_words_title word ids, or 1 doc pointer), then the
        optional category and subcategory columns."""
        title_w = self.num_words_title if self.title_source == "word_ids" else 1
        return title_w + int(self.use_category) + int(self.use_subcategory)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
