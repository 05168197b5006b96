"""Offline per-title embedding precompute and the frozen-table store.

Every news title is embedded offline, cut or zero-padded to
``num_words_title`` tokens and flattened to one row of
``num_words_title*dim``. The files, the same as the JAX package's
(reference preprocess.py:112-239):
  - title_embeddings.{backend}.npy.gz: the gzip'd numpy table, row 0 all
    zero for unknown news,
  - embeddings_doc_ids.pkl: row index -> doc id ('' for row 0),
  - doc_id_dict.pkl: doc id -> 1-based row index.

Backends:
  - "bpemb": multilingual BPEmb 320k/300d, if the package is installed.
  - "bert":  a BERT model's last-4-hidden-layer sum per token, if
             ``transformers`` is installed; NEWSREC_BERT_MODEL names the
             model or a local save_pretrained directory.
  - "hash":  deterministic pseudo-embeddings from token hashes, no
             download: the JAX package's table bit for bit.
"""

from __future__ import annotations

import gzip
import hashlib
import logging
import os
import pickle
from typing import Dict, List

import numpy as np

from newsrecommendation_tpu_torch.data.mind import tokenize

_TABLE_FILE = "title_embeddings.{backend}.npy.gz"


def _hash_token_vec(token: str, dim: int) -> np.ndarray:
    """Deterministic unit-scale vector from a token's sha256 digest."""
    h = hashlib.sha256(token.encode("utf-8")).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    return rng.normal(0.0, 1.0 / np.sqrt(dim), size=dim).astype(np.float32)


class _HashEmbedder:
    def __init__(self, dim: int):
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def embed(self, title: str) -> np.ndarray:
        toks = tokenize(title)
        if not toks:
            return np.zeros((0, self.dim), dtype=np.float32)
        rows = []
        for t in toks:
            if t not in self._cache:
                self._cache[t] = _hash_token_vec(t, self.dim)
            rows.append(self._cache[t])
        return np.stack(rows)


class _BPEmbEmbedder:
    def __init__(self, dim: int):
        from bpemb import BPEmb  # optional dependency

        self.model = BPEmb(lang="multi", vs=320000, dim=dim)
        self.dim = dim

    def embed(self, title: str) -> np.ndarray:
        return np.asarray(self.model.embed(title), dtype=np.float32)


class _BertEmbedder:
    """Per-token contextual vectors: the sum of the last 4 hidden layers,
    [CLS]/[SEP] stripped (reference preprocess.py:80-103), on the CPU."""

    def __init__(self, dim: int = 768):
        import torch
        from transformers import AutoModel, AutoTokenizer

        name = os.environ.get("NEWSREC_BERT_MODEL", "bert-base-uncased")
        self.torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(name)
        self.model = AutoModel.from_pretrained(name,
                                               output_hidden_states=True)
        self.model.eval()
        self.dim = dim

    def embed(self, title: str) -> np.ndarray:
        with self.torch.no_grad():
            enc = self.tokenizer.encode_plus(title, return_tensors="pt")
            out = self.model(**enc)
        states = out.hidden_states
        summed = sum(states[i] for i in (-4, -3, -2, -1)).squeeze(0)
        return summed[1:-1].numpy().astype(np.float32)


_BACKENDS = {"hash": _HashEmbedder, "bpemb": _BPEmbEmbedder,
             "bert": _BertEmbedder}


def make_embedder(backend: str, dim: int):
    try:
        return _BACKENDS[backend](dim)
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; options: {sorted(_BACKENDS)}")
    except ImportError as e:
        raise ImportError(
            f"embedding backend {backend!r} needs an optional dependency: "
            f"{e}. Use backend='hash' for an offline-safe table.") from e


def create_news_embeddings(data_dir: str, num_tokens_title: int,
                           dim: int = 300, backend: str = "hash") -> np.ndarray:
    """Build and store the flattened per-title table of one data dir.

    Returns the (num_news+1, num_tokens_title*dim) float32 table.
    """
    embedder = make_embedder(backend, dim)
    news_path = os.path.join(data_dir, "news.tsv")
    table_path = os.path.join(data_dir, _TABLE_FILE.format(backend=backend))
    logging.info("embedding titles from %s -> %s", news_path, table_path)

    doc_id_dict: Dict[str, int] = {}
    doc_ids: List[str] = [""]  # row 0 = unknown-news placeholder
    rows = [np.zeros((num_tokens_title, dim), dtype=np.float32)]
    with open(news_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            doc_id, title = parts[0], parts[3]
            if doc_id in doc_id_dict:
                continue
            doc_id_dict[doc_id] = len(doc_id_dict) + 1
            doc_ids.append(doc_id)
            vecs = embedder.embed(title)[:num_tokens_title]
            vecs = np.pad(vecs,
                          ((0, num_tokens_title - vecs.shape[0]), (0, 0)))
            rows.append(vecs.astype(np.float32))

    table = np.stack(rows).reshape(len(rows), -1)
    with gzip.GzipFile(table_path, "w") as f:
        np.save(f, table)
    with open(os.path.join(data_dir, "embeddings_doc_ids.pkl"), "wb") as f:
        pickle.dump(doc_ids, f)
    with open(os.path.join(data_dir, "doc_id_dict.pkl"), "wb") as f:
        pickle.dump(doc_id_dict, f)
    return table


def read_news_embeddings(data_dir: str, backend: str = "hash") -> np.ndarray:
    """Load a stored table (reference preprocess.py:227-239), trying
    ``backend``'s file first, then the other backends'."""
    tried = []
    for b in [backend] + [x for x in _BACKENDS if x != backend]:
        path = os.path.join(data_dir, _TABLE_FILE.format(backend=b))
        tried.append(path)
        if os.path.exists(path):
            with gzip.GzipFile(path, "r") as f:
                return np.load(f)
    raise FileNotFoundError(
        f"no title-embedding table found; tried {tried}. "
        f"Run mode=create_embeddings first.")
