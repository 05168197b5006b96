"""Frozen dataclass configuration for the PyTorch port.

Every field of the JAX package's Config, under its names and with its
defaults and checks, so one set of keyword arguments builds a config for
either side and ``config_from_args`` parses the same command line.
``check_supported`` refuses the values the port does not run: params
other than f32, and the plain route on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- model family ------------------------------------------------------
    model: str = "NRMS"  # registry key: "NRMS" | "NAML"
    # "word_ids": (num_news+1, num_words_title) word ids into a word table;
    # "doc_table": one doc-index column into a frozen per-title table of
    # shape (num_news+1, num_words_title*word_embedding_dim).
    title_source: str = "word_ids"

    # ---- model dims --------------------------------------------------------
    num_words_title: int = 20
    num_words_abstract: int = 50  # parsed, unused downstream (as in JAX)
    user_log_length: int = 50
    word_embedding_dim: int = 300
    news_dim: int = 400
    news_query_vector_dim: int = 200
    user_query_vector_dim: int = 200
    num_attention_heads: int = 20
    category_emb_dim: int = 100  # NAML's category views
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

    # ---- data, paths and modes ---------------------------------------------
    filter_num: int = 3  # min word count for the word vocab
    # train | test | train_test | create_embeddings | read_embeddings | serve
    mode: str = "train"
    prepare: bool = True  # rewrite the behaviors shards before a run
    train_data_dir: str = "data/MINDsmall_train"
    test_data_dir: str = "data/MINDsmall_dev"
    model_dir: str = "model"  # checkpoints and metrics.jsonl
    load_ckpt_name: Optional[str] = None  # a file in model_dir, or "latest"
    glove_embedding_path: Optional[str] = None
    # per-title table backend of --mode create_embeddings: "bpemb", "bert"
    # or "hash" (deterministic, no download)
    embedding_backend: str = "bpemb"
    tokenizer: str = "treebank"  # "treebank" | "regex"

    # ---- execution ---------------------------------------------------------
    # ranks on the data axis; 0: every card left after table sharding
    data_parallel: int = 0
    table_shards: int = 1  # >1: the title table row-sharded over ranks
    compute_dtype: str = "float32"  # "float32" | "bfloat16" activations
    param_dtype: str = "float32"  # params stay f32
    eval_batch_size: int = 128  # impressions per eval batch
    # k > 1: eval batches staged k at a time and run back to back; the
    # leftovers one at a time. The same sums as k = 1.
    eval_steps_per_call: int = 8
    max_candidates: int = 384  # eval impression width; wider ones raise
    donate_state: bool = True  # the port's steps update the state in place
    # "auto" | "on": the CUDA kernels on the card (the CPU always takes
    # their plain versions); "off", the plain route on the card, is refused
    use_pallas: str = "auto"
    # What the attention forward saves for its backward: "probs" (the f32
    # attention probs; kernel rows 2-3) or "recompute" (nothing; the
    # backward recomputes them, rows 1 and 4). Same gradients.
    bwd_residuals: str = "probs"
    # "on": each NRMS encoder tail (MHSA -> dropout -> pooling) runs as one
    # kernel (rows 13-14); "auto" and "off" compose it from rows 1-4.
    fused_tail: str = "auto"  # "auto" | "on" | "off"
    attention_layout: str = "headloop"  # "headloop" | "blanes"
    eval_news_chunk: int = 1024  # corpus rows per news-encoder call
    # ---- serving (--mode serve; server.py) ---------------------------------
    serve_host: str = "127.0.0.1"
    serve_port: int = 8000  # 0: a free port
    serve_max_batch: int = 128  # micro-batching coalescing cap
    serve_max_delay_ms: float = 15.0  # longest wait to fill a batch
    serve_pipeline_depth: int = 2  # batches in flight; 0: synchronous
    serve_scorer: str = "auto"  # "auto" | "gather" | "dense"
    # Recommender's "auto" scorer: dense (whole-corpus matmul) while the
    # cache has at most this many rows, gather (candidate rows only) above.
    serve_dense_max_rows: int = 524288
    serve_cache_dtype: str = "float32"  # "bfloat16" halves the cache
    debug_nans: bool = False  # autograd anomaly detection: fail at a NaN

    # ---- the reference's flags kept for its command lines -------------------
    nGPU: int = 1  # N > 1: data_parallel min(N, cards) when it is 0
    enable_gpu: bool = True  # ignored: the entry points' device decides

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
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"unknown use_pallas {self.use_pallas!r}")
        if self.fused_tail not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_tail {self.fused_tail!r}")
        if self.attention_layout not in ("headloop", "blanes"):
            raise ValueError(
                f"unknown attention_layout {self.attention_layout!r}")
        if self.bwd_residuals not in ("recompute", "probs"):
            raise ValueError(
                f"unknown bwd_residuals {self.bwd_residuals!r}")
        if self.embedding_backend not in ("bpemb", "bert", "hash"):
            raise ValueError(
                f"unknown embedding_backend {self.embedding_backend!r}")
        if self.tokenizer not in ("treebank", "regex"):
            raise ValueError(f"unknown tokenizer {self.tokenizer!r}")
        if self.serve_scorer not in ("auto", "gather", "dense"):
            raise ValueError(f"unknown serve_scorer {self.serve_scorer!r}")
        if self.serve_cache_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown serve_cache_dtype {self.serve_cache_dtype!r}")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, "
                             f"got {self.steps_per_call}")
        if self.eval_steps_per_call < 1:
            raise ValueError(f"eval_steps_per_call must be >= 1, "
                             f"got {self.eval_steps_per_call}")
        if self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, "
                             f"got {self.prefetch_depth}")

    @property
    def dim_per_head(self) -> int:
        return self.news_dim // self.num_attention_heads

    @property
    def num_title_views(self) -> int:
        """NAML multi-view count: title + optional category/subcategory."""
        return 1 + int(self.use_category) + int(self.use_subcategory)

    @property
    def news_feature_width(self) -> int:
        """Width of one row of the combined news-feature matrix: the title
        columns (num_words_title word ids, or 1 doc pointer), then the
        optional category and subcategory columns."""
        title_w = self.num_words_title if self.title_source == "word_ids" else 1
        return title_w + int(self.use_category) + int(self.use_subcategory)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: Config, device=None) -> None:
    """Raise ValueError for a setting the port does not run, rather than
    ignore it. ``device``: where the run goes; "off" is refused on CUDA
    only, since on the CPU every kernel takes its plain version anyway."""
    if cfg.param_dtype != "float32":
        raise ValueError(f"--param_dtype {cfg.param_dtype}: the port keeps "
                         "its params in float32")
    if cfg.use_pallas == "off" and device is not None and (
            torch.device(device).type == "cuda"):
        raise ValueError(
            "--use_pallas off: the port has no plain route on the card (a "
            "CUDA tensor launches its kernel or raises); run on the CPU for "
            "the plain versions")


def config_from_args(argv=None) -> Config:
    """Parse the JAX package's command line (the reference's flag names)
    into a Config: one flag per field, booleans as yes/no words. Settings
    the port does not run raise (check_supported)."""
    import argparse

    def str2bool(v):
        if isinstance(v, bool):
            return v
        if v.lower() in ("yes", "true", "t", "y", "1"):
            return True
        if v.lower() in ("no", "false", "f", "n", "0"):
            return False
        raise argparse.ArgumentTypeError("Boolean value expected.")

    p = argparse.ArgumentParser(prog="newsrecommendation_tpu_torch")
    defaults = Config()
    for f in dataclasses.fields(Config):
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            kind = str2bool
        elif isinstance(default, (int, float)):
            kind = type(default)
        else:
            kind = str
        p.add_argument(f"--{f.name}", type=kind, default=default)
    cfg = Config(**vars(p.parse_args(argv)))
    check_supported(cfg)
    return cfg
