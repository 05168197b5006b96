"""Candidate scoring: dot products of candidate news vectors with the user
vector. Plain PyTorch: the JAX package leaves these to XLA too."""

from __future__ import annotations

import torch


def score_candidates(candidate_vecs: torch.Tensor,
                     user_vec: torch.Tensor) -> torch.Tensor:
    """candidate_vecs: (..., C, D); user_vec: (..., D) -> scores (..., C)."""
    return torch.einsum("...cd,...d->...c", candidate_vecs, user_vec)


def score_cached_impressions(news_scoring, candidate_idx, user_vecs):
    """Gather + score against the whole-corpus news-vector cache.

    news_scoring: (N, D) cache; candidate_idx: (B, C) int into the cache
    (0 = unknown/padding row); user_vecs: (B, D). Returns (B, C) scores.
    Reads B*C random rows: best when B*C << N.
    """
    return score_candidates(news_scoring[candidate_idx], user_vecs)


def score_cached_impressions_dense(news_scoring, candidate_idx, user_vecs):
    """Same contract as score_cached_impressions: scores the whole corpus
    with one (B, D) x (D, N) matmul, then gathers the B*C requested
    scalars. Streams the cache instead of gathering rows at random."""
    all_scores = user_vecs @ news_scoring.T  # (B, N)
    return torch.gather(all_scores, 1, candidate_idx)
