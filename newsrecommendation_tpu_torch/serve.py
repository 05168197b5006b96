"""Serving API: precomputed news-vector cache + batched impression scoring.

Build once from a checkpoint or live params, then score candidate sets for
user histories with one gather + user-encode + dot computation on the
device:

    rec = Recommender.from_checkpoint(ckpt_path, cfg, test_data_dir)
    rec = Recommender.from_state(cfg, params, news_index, news_features)
    scores = rec.score(history_doc_ids, candidate_doc_ids)
    ranked = rec.rank(history_doc_ids, candidate_doc_ids)
    top10 = rec.recommend(history_doc_ids, k=10)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from newsrecommendation_tpu_torch.data.loader import (
    pad_to_fix_len,
    trans_to_nindex,
)
from newsrecommendation_tpu_torch.eval.pipeline import compute_news_scoring
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.ops import kernel_config
from newsrecommendation_tpu_torch.ops.scoring import (
    score_cached_impressions,
    score_cached_impressions_dense,
)
from newsrecommendation_tpu_torch.utils import resolve_device, to_device

# Serving-cache row-padding granularity (see Recommender.__init__).
_CACHE_ROW_BUCKET = 4096


class Recommender:
    """Whole-corpus news-vector cache + impression scorer on one device.

    scorer: "gather" (random candidate-row gather; cost ~ candidates only),
    "dense" (whole-corpus matmul + scalar gather), or "auto" (default):
    dense while the corpus has <= cfg.serve_dense_max_rows rows, gather
    above.
    """

    def __init__(self, model, params, cfg, news_index: Dict[str, int],
                 news_scoring, *, device="cuda", scorer: str = "auto",
                 cache_dtype: Optional[str] = None):
        self.device = resolve_device(device)
        self.model = model
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.news_index = news_index
        # The cache rows are padded up to a multiple of _CACHE_ROW_BUCKET
        # with zero vectors, so a corpus that grows within the bucket keeps
        # every shape. Padded rows are unreachable by doc id and masked to
        # -inf for corpus-wide top-k. The real row count comes from
        # news_index, which must be dense and 1-based: a gapped index would
        # mask real rows out of top-k, an explicit 0 would collide with the
        # unknown-news row.
        if news_index:
            vals = news_index.values()
            if max(vals) != len(news_index) or min(vals) < 1:
                raise ValueError(
                    "news_index must be a dense 1-based mapping "
                    f"(got {len(news_index)} ids spanning "
                    f"[{min(vals)}, {max(vals)}])")
        self._real_rows = len(news_index) + 1  # + row 0 (unknown news)
        cache = torch.as_tensor(news_scoring).to(self.device)
        if cache.shape[0] < self._real_rows:
            raise ValueError(
                f"news_scoring has {cache.shape[0]} rows but news_index "
                f"addresses {self._real_rows} (incl. row 0)")
        pad = (-cache.shape[0]) % _CACHE_ROW_BUCKET
        if pad:
            cache = torch.cat([cache, cache.new_zeros((pad, cache.shape[1]))])
        if cache_dtype:
            cache = cache.to(getattr(torch, cache_dtype))
        self.news_scoring = cache
        if scorer not in ("auto", "gather", "dense"):
            raise ValueError(f"unknown scorer {scorer!r}")
        if scorer == "auto":
            scorer = ("dense" if self._real_rows <= cfg.serve_dense_max_rows
                      else "gather")
        self.scorer = scorer
        self._scorer = (score_cached_impressions if scorer == "gather"
                        else score_cached_impressions_dense)
        # row index -> doc id for corpus-wide recommendation output
        self._inv_index = {v: k for k, v in news_index.items()}

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_state(cls, cfg, params, news_index: Dict[str, int],
                   news_features: np.ndarray, *, device="cuda",
                   **kw) -> "Recommender":
        """Encode the corpus with ``params`` on ``device`` and build the
        recommender (raises if ``device`` is "cuda" and CUDA is missing).
        Sets the kernel switches cfg carries (kernel_config.apply)."""
        dev = resolve_device(device)
        kernel_config.apply(cfg)
        model = get_model(cfg.model)
        params = to_device(params, dev)
        cache = compute_news_scoring(model, params, cfg, news_features)
        return cls(model, params, cfg, news_index, cache, device=dev, **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, cfg, data_dir: str, *,
                        device="cuda", **kw) -> "Recommender":
        """Load a checkpoint and build the cache from data_dir's corpus:
        the sidecar's vocabs read data_dir/news.tsv, the title table is
        built for that corpus (cli.build_embedding_table), a model of that
        shape takes the checkpoint's params (load_checkpoint; a table a
        run on several ranks saved in shards comes in whole), and
        from_state encodes the corpus on ``device``."""
        import json
        import os

        from newsrecommendation_tpu_torch.ckpt import load_checkpoint
        from newsrecommendation_tpu_torch.cli import build_embedding_table
        from newsrecommendation_tpu_torch.data import (
            build_news_features,
            read_news,
        )
        from newsrecommendation_tpu_torch.train import create_train_state

        dev = resolve_device(device)
        with open(ckpt_path + ".json", "r", encoding="utf-8") as f:
            sidecar = json.load(f)
        corpus = read_news(
            os.path.join(data_dir, "news.tsv"), cfg, "test",
            category_dict=sidecar.get("category_dict", {}),
            subcategory_dict=sidecar.get("subcategory_dict", {}),
            word_dict=sidecar.get("word_dict", {}))
        table = build_embedding_table(cfg, data_dir, corpus)
        model = get_model(cfg.model)
        template = create_train_state(
            cfg, model.init(cfg, table,
                            num_category=len(corpus.category_dict),
                            num_subcategory=len(corpus.subcategory_dict),
                            seed=0, device=dev))
        state, _ = load_checkpoint(ckpt_path, template, cfg)
        return cls.from_state(cfg, state.params, corpus.news_index,
                              build_news_features(corpus, cfg), device=dev,
                              **kw)

    # ---- scoring ---------------------------------------------------------

    @property
    def corpus_size(self) -> int:
        """Number of real (addressable) news rows, excluding row 0."""
        return self._real_rows - 1

    def _user_vecs(self, hist_idx, hist_mask):
        hist_vecs = self.news_scoring[hist_idx]
        return self.model.user_encoder(self.params, self.cfg, hist_vecs,
                                       hist_mask)

    def _history_arrays(self, histories: Sequence[Sequence[str]]):
        L = self.cfg.user_log_length
        hist = np.zeros((len(histories), L), np.int64)
        mask = np.zeros((len(histories), L), np.float32)
        for i, h in enumerate(histories):
            hist[i], mask[i] = pad_to_fix_len(
                trans_to_nindex(list(h), self.news_index), L)
        return hist, mask

    def _tensors(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    @torch.inference_mode()
    def score_batch_async(self, histories: Sequence[Sequence[str]],
                          candidates: Sequence[Sequence[str]],
                          max_candidates: Optional[int] = None):
        """Queue scoring on the device; returns the (B, C) device tensor
        without waiting for it. Callers that overlap several batches in
        flight (server.py's BatchingScorer) copy it to the host later;
        everyone else should use score_batch."""
        if max_candidates is None:
            max_candidates = max((len(c) for c in candidates), default=1)
        hist, mask = self._history_arrays(histories)
        cand = np.zeros((len(histories), max_candidates), np.int64)
        for i, c in enumerate(candidates):
            idx = trans_to_nindex(list(c)[:max_candidates], self.news_index)
            cand[i, :len(idx)] = idx
        hist, mask, cand = self._tensors(hist, mask, cand)
        return self._scorer(self.news_scoring, cand,
                            self._user_vecs(hist, mask))

    def score_batch(self, histories: Sequence[Sequence[str]],
                    candidates: Sequence[Sequence[str]],
                    max_candidates: Optional[int] = None) -> np.ndarray:
        """Scores (B, C) for B users' candidate lists (doc-id strings)."""
        out = self.score_batch_async(histories, candidates, max_candidates)
        return out.float().cpu().numpy()

    def score(self, history: Sequence[str],
              candidates: Sequence[str]) -> np.ndarray:
        """(C,) scores for one user."""
        return self.score_batch([history], [candidates],
                                max_candidates=len(candidates))[0]

    def rank(self, history: Sequence[str],
             candidates: Sequence[str]) -> List[str]:
        """Candidates sorted by descending score."""
        s = self.score(history, candidates)
        order = np.argsort(-s, kind="stable")
        return [list(candidates)[i] for i in order]

    def recommend(self, history: Sequence[str], k: int = 10) -> List[str]:
        """Top-k doc ids over the WHOLE corpus for one user."""
        ids, _ = self.recommend_batch([history], k)
        return ids[0]

    @torch.inference_mode()
    def recommend_batch_async(self, histories: Sequence[Sequence[str]],
                              k: int = 10):
        """Queue corpus-wide top-k: one dense (B, D) x (D, N) matmul, row 0
        (unknown news) and the zero padding rows masked to -inf, then
        torch.topk. Returns (scores, idx) device tensors without waiting;
        finish on the host with finish_recommend_batch."""
        hist, mask = self._tensors(*self._history_arrays(histories))
        user_vecs = self._user_vecs(hist, mask)
        scores = (user_vecs @ self.news_scoring.T).float()
        scores[:, self._real_rows:] = -torch.inf
        scores[:, 0] = -torch.inf
        k = min(int(k), self._real_rows)
        return torch.topk(scores, k, dim=1)

    def finish_recommend_batch(self, scores, idx):
        """Blocking half of recommend_batch: copy the results to the host
        and map row indices back to doc ids (padding row 0 filtered)."""
        idx, scores = idx.cpu().numpy(), scores.cpu().numpy()
        ids_out, scores_out = [], []
        for r_idx, r_sc in zip(idx, scores):
            pairs = [(self._inv_index[int(i)], float(s))
                     for i, s in zip(r_idx, r_sc)
                     if int(i) in self._inv_index]
            ids_out.append([p[0] for p in pairs])
            scores_out.append([p[1] for p in pairs])
        return ids_out, scores_out

    def recommend_batch(self, histories: Sequence[Sequence[str]],
                        k: int = 10):
        """Batched corpus-wide top-k: (ids, scores), each a list of B
        aligned lists. k is clamped to the corpus size."""
        scores, idx = self.recommend_batch_async(histories, k)
        return self.finish_recommend_batch(scores, idx)
