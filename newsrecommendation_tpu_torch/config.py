"""Frozen dataclass configuration for the PyTorch port.

The fields NRMS serving reads, under the JAX package's names and with its
defaults, so one set of keyword arguments builds a config for either side.
Fields of slices not yet ported (training, checkpoints and the CLI's serve
settings, NAML, sharding) are left out until those slices land.
"""

from __future__ import annotations

import dataclasses


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

    # ---- data --------------------------------------------------------------
    filter_num: int = 3  # min word count for the word vocab
    tokenizer: str = "treebank"  # "treebank" | "regex"

    # ---- execution ---------------------------------------------------------
    compute_dtype: str = "float32"  # "float32" | "bfloat16" activations
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
        if self.tokenizer not in ("treebank", "regex"):
            raise ValueError(f"unknown tokenizer {self.tokenizer!r}")

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
