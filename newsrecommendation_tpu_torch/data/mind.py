"""MIND corpus reading, vocab building, and fixed-shape news-feature matrices.

The port's own copy of the JAX package's ``data/mind.py``.

Behavioral parity with reference ``preprocess.py:16-72``:
  - news.tsv is 8 tab-separated columns: doc_id, category, subcategory,
    title, abstract, url, +2 unused (preprocess.py:26).
  - doc ids, categories, subcategories get 1-based indices in first-seen
    order; index 0 is reserved for "unknown" everywhere (preprocess.py:8-13).
  - vocab dicts are built in train mode only; test mode maps unseen
    categories to 0 (preprocess.py:32-36, preprocess.py:67-70).
  - the combined feature matrix has one row per news item (+ zero row 0) with
    title columns first, then category, then subcategory (main.py:44-48).

The word-id title path restores the upstream pipeline the fork commented out
(preprocess.py:29-41 commented lines; the published README numbers come from
it): titles are tokenized, words with count > filter_num get 1-based ids, and
the title columns hold ``num_words_title`` word ids (0-padded).
"""

from __future__ import annotations

import dataclasses
import os
import re
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

# Fast lowercase regex tokenizer: word-internal apostrophes kept,
# punctuation as separate tokens (a cheap approximation of nltk
# word_tokenize; NOT vocabulary-identical to it).
_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)*|[^\sa-z0-9]")


def tokenize(text: str, kind: str = "treebank") -> List[str]:
    """Lowercase + word-tokenize a title.

    kind="treebank" (default) reproduces the upstream pipeline's
    ``word_tokenize(title.lower())`` (reference preprocess.py:29-30) via the
    dependency-free NLTK-faithful reimplementation in data/tokenizer.py —
    the vocabulary-parity path for the README numbers. kind="regex" is the
    faster approximation (distinct vocab; fine for synthetic experiments).
    """
    if kind == "regex":
        return _TOKEN_RE.findall(text.lower())
    if kind == "treebank":
        from newsrecommendation_tpu_torch.data.tokenizer import (
            treebank_word_tokenize,
        )
        return treebank_word_tokenize(text.lower())
    raise ValueError(f"unknown tokenizer {kind!r}")


def _assign_id(d: dict, key) -> None:
    """1-based first-seen-order ids (reference update_dict, preprocess.py:8-13)."""
    if key not in d:
        d[key] = len(d) + 1


@dataclasses.dataclass
class NewsCorpus:
    """Parsed news.tsv plus vocabularies."""

    news_index: Dict[str, int]          # doc_id -> 1-based index
    categories: Dict[str, tuple]        # doc_id -> (category, subcategory)
    titles: Dict[str, List[str]]        # doc_id -> tokenized title
    raw_titles: Dict[str, str]          # doc_id -> raw title text
    category_dict: Dict[str, int]       # category -> 1-based id (train only)
    subcategory_dict: Dict[str, int]    # subcategory -> 1-based id (train only)
    word_dict: Dict[str, int]           # word -> 1-based id (train only)

    @property
    def num_news(self) -> int:
        return len(self.news_index)


def read_news(news_path: str, cfg, mode: str = "train",
              category_dict: Optional[dict] = None,
              subcategory_dict: Optional[dict] = None,
              word_dict: Optional[dict] = None) -> NewsCorpus:
    """Parse news.tsv. In test mode, pass the train-time vocab dicts."""
    if mode not in ("train", "test"):
        raise ValueError(f"wrong mode {mode!r}")
    news_index: Dict[str, int] = {}
    categories: Dict[str, tuple] = {}
    titles: Dict[str, List[str]] = {}
    raw_titles: Dict[str, str] = {}
    cat_d: Dict[str, int] = {} if mode == "train" else dict(category_dict or {})
    subcat_d: Dict[str, int] = {} if mode == "train" else dict(subcategory_dict or {})
    word_counts: Counter = Counter()

    with open(news_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            doc_id, category, subcategory, title = parts[0], parts[1], parts[2], parts[3]
            _assign_id(news_index, doc_id)
            if doc_id not in categories:
                categories[doc_id] = (category, subcategory)
                toks = tokenize(title, getattr(cfg, "tokenizer", "treebank"))
                titles[doc_id] = toks
                raw_titles[doc_id] = title
                if mode == "train":
                    word_counts.update(toks)
            if mode == "train":
                if cfg.use_category:
                    _assign_id(cat_d, category)
                if cfg.use_subcategory:
                    _assign_id(subcat_d, subcategory)

    if mode == "train":
        # words kept when count > filter_num (upstream semantics,
        # preprocess.py:39-41 commented reference)
        kept = [w for w, c in word_counts.items() if c > cfg.filter_num]
        w_d = {w: i for i, w in enumerate(kept, start=1)}
    else:
        w_d = dict(word_dict or {})

    return NewsCorpus(
        news_index=news_index, categories=categories, titles=titles,
        raw_titles=raw_titles, category_dict=cat_d, subcategory_dict=subcat_d,
        word_dict=w_d,
    )


def build_news_features(corpus: NewsCorpus, cfg) -> np.ndarray:
    """Combined int32 feature matrix, shape (num_news+1, F); row 0 all-zero.

    Column layout (title cols, then category, then subcategory) matches the
    reference's news_combined concatenation (main.py:48):
      title_source="word_ids":  num_words_title word-id columns.
      title_source="doc_table": 1 column holding the doc index itself — a
      pointer into the precomputed per-title embedding table
      (preprocess.py:64-65).
    """
    n = corpus.num_news + 1
    title_w = cfg.num_words_title if cfg.title_source == "word_ids" else 1
    out = np.zeros((n, cfg.news_feature_width), dtype=np.int32)

    for doc_id, idx in corpus.news_index.items():
        if cfg.title_source == "word_ids":
            toks = corpus.titles[doc_id][: cfg.num_words_title]
            for j, w in enumerate(toks):
                out[idx, j] = corpus.word_dict.get(w, 0)
        else:
            out[idx, 0] = idx
        col = title_w
        if cfg.use_category:
            cat = corpus.categories[doc_id][0]
            out[idx, col] = corpus.category_dict.get(cat, 0)
            col += 1
        if cfg.use_subcategory:
            subcat = corpus.categories[doc_id][1]
            out[idx, col] = corpus.subcategory_dict.get(subcat, 0)
    return out


def load_glove_matrix(path: str, word_dict: Dict[str, int], dim: int):
    """Stream a GloVe text file into a (V+1, dim) matrix (utils.py:64-80).

    Returns (matrix, have_words). Rows for out-of-GloVe words, row 0 too,
    stay zero; a missing file gives all zeros.
    """
    matrix = np.zeros((len(word_dict) + 1, dim), dtype=np.float32)
    have = []
    if path is not None and os.path.exists(path):
        with open(path, "rb") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                word = parts[0].decode("utf-8", errors="ignore")
                if word in word_dict:
                    matrix[word_dict[word]] = np.asarray(
                        [float(x) for x in parts[1:]], dtype=np.float32)
                    have.append(word)
    return matrix, have


def random_word_embeddings(word_dict: Dict[str, int], dim: int, seed: int = 0):
    """Trainable word-embedding init when no GloVe file is available:
    N(0, 1/sqrt(dim)) rows, zero row 0 (padding)."""
    rng = np.random.default_rng(seed)
    matrix = rng.normal(0.0, 1.0 / np.sqrt(dim),
                        size=(len(word_dict) + 1, dim)).astype(np.float32)
    matrix[0] = 0.0
    return matrix
