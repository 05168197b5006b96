"""Host-side input: history and candidate index helpers shared by serving
and training, the training shards parsed once into dense numpy arrays
(``TrainSamples``) with fixed-shape padded batches built by vectorised ops,
and the eval shards (``EvalSamples``) with impressions padded to a fixed
candidate width.

  - id -> index mapping with 0 for unknown news,
  - FRONT-padded, most-recent-L click history with a 0/1 float mask,
  - a fresh uniformly random positive slot among the npratio negatives per
    sample and epoch, the slot index being the label,
  - the final partial batch padded, with a 0/1 ``weight`` per sample so a
    step sees one shape while the loss equals that of the ragged batch.
Same arrays as the JAX package's loader for the same files and seeds.

Two parsers give the same arrays: the native one (``native_loader``,
``csrc/mindio.cpp``), taken by default, and the pure-Python one, taken
with ``use_native=False``, for an eval shard without ``max_candidates``,
or when the native library cannot be built. Each parse logs its parser,
path, rows and seconds and notes the parser in ``native_loader``. A line
with too few fields raises ``ParseError`` (a ValueError) naming the file
and line; an empty file gives arrays of 0 rows.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from newsrecommendation_tpu_torch.data import native_loader
from newsrecommendation_tpu_torch.data.native_loader import ParseError


class CandidateTruncationError(ValueError):
    """Raised when an eval impression has more candidates than the padded
    width: dropping the excess would silently corrupt ranking metrics."""


def _guard_truncation(path: str, truncated: int, max_width: int,
                      width: int, allow: bool) -> None:
    if truncated <= 0:
        return
    msg = (f"{path}: {truncated} impression(s) exceed the eval candidate "
           f"width {width} (widest observed: {max_width}); their excess "
           f"candidates would be silently dropped from AUC/MRR/nDCG. "
           f"Raise max_candidates (--max_candidates) to >= {max_width}.")
    if allow:
        logging.warning("%s (allow_truncation=True: continuing)", msg)
        return
    raise CandidateTruncationError(msg)


def trans_to_nindex(nids: List[str], news_index: Dict[str, int]) -> List[int]:
    """doc ids -> 1-based indices, 0 for unknown (reference dataset.py:14-15)."""
    return [news_index.get(i, 0) for i in nids]


def pad_to_fix_len(x: List[int], fix_length: int, padding_front: bool = True,
                   padding_value: int = 0):
    """Reference dataset.py:17-24: keep the LAST fix_length entries; front-pad
    by default. Returns (padded list, float32 mask)."""
    if padding_front:
        pad_x = [padding_value] * (fix_length - len(x)) + x[-fix_length:]
        mask = [0] * (fix_length - len(x)) + [1] * min(fix_length, len(x))
    else:
        pad_x = x[-fix_length:] + [padding_value] * (fix_length - len(x))
        mask = [1] * min(fix_length, len(x)) + [0] * (fix_length - len(x))
    return pad_x, np.asarray(mask, dtype=np.float32)


def _parse_lines(path: str, min_fields: int, parse) -> None:
    """parse(fields) on each line of ``path``, split on tabs. A line with
    fewer than ``min_fields`` fields, or that ``parse`` cannot read,
    raises ParseError naming the file and the 1-based line, as the native
    parser does."""
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.rstrip("\n").split("\t")
            try:
                if len(parts) < min_fields:
                    raise IndexError(len(parts))
                parse(parts)
            except (IndexError, ValueError):
                raise ParseError(f"{path}:{lineno}: malformed behaviors "
                                 f"line") from None


def _rows(rows: list, dtype, width: int) -> np.ndarray:
    """The rows as an (N, width) array; (0, width) when there are none."""
    if not rows:
        return np.zeros((0, width), dtype)
    return np.asarray(rows, dtype=dtype)


def _note(parser: str, path: str, rows: int, t0: float) -> None:
    native_loader.record(parser)
    logging.info("%s: %d rows by the %s parser in %.3f s", path, rows,
                 parser, time.perf_counter() - t0)


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """x with zero rows appended up to n rows (x itself when it has n)."""
    if x.shape[0] == n:
        return x
    return np.concatenate([x, np.zeros((n - x.shape[0],) + x.shape[1:],
                                       x.dtype)])


@dataclasses.dataclass
class TrainSamples:
    """One training shard (behaviors_np{K}_{r}.tsv) as dense arrays."""

    history: np.ndarray       # (N, L) int32 news indices, front-padded with 0
    history_mask: np.ndarray  # (N, L) float32
    pos: np.ndarray           # (N,) int32 positive news index
    neg: np.ndarray           # (N, K) int32 negative news indices

    @property
    def num_samples(self) -> int:
        return self.history.shape[0]

    @property
    def npratio(self) -> int:
        return self.neg.shape[1]

    @classmethod
    def from_file(cls, path: str, news_index: Dict[str, int], cfg,
                  use_native: bool = True) -> "TrainSamples":
        """Parse a prepared shard (iid, uid, time, history, pos, negs),
        natively unless ``use_native`` is False or the native library
        cannot be built."""
        t0 = time.perf_counter()
        L, K = cfg.user_log_length, cfg.npratio
        if use_native:
            parsed = native_loader.parse_train_file(path, news_index, L, K)
            if parsed is not None:
                h, m, p, n = parsed
                out = cls(history=h, history_mask=m, pos=p, neg=n)
                _note("native", path, out.num_samples, t0)
                return out
        hist, mask, pos, neg = [], [], [], []

        def parse(parts):
            h, m = pad_to_fix_len(
                trans_to_nindex(parts[3].split(), news_index), L)
            p = trans_to_nindex(parts[4].split(), news_index)[0]
            hist.append(h)
            mask.append(m)
            pos.append(p)
            neg.append(trans_to_nindex(parts[5].split(), news_index))

        _parse_lines(path, 6, parse)
        out = cls(history=_rows(hist, np.int32, L),
                  history_mask=_rows(mask, np.float32, L),
                  pos=np.asarray(pos, dtype=np.int32),
                  neg=_rows(neg, np.int32, K))
        _note("python", path, out.num_samples, t0)
        return out

    def epoch_arrays(self, epoch: int, seed: int, shuffle: bool = False):
        """(history, history_mask, candidate (N, 1+K), label (N,)) with a
        fresh uniformly random positive slot per sample, drawn from
        (seed, epoch). shuffle=True also permutes the sample order."""
        n, k = self.num_samples, self.npratio
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        label = rng.integers(0, k + 1, size=n).astype(np.int32)
        # candidate[:, j] = neg[:, j] for j < label, pos at j == label,
        # neg[:, j-1] for j > label: pos inserted at the label slot
        j = np.arange(k + 1)[None, :]
        lab = label[:, None]
        neg_shifted = np.take_along_axis(
            self.neg, np.clip(j - (j > lab), 0, k - 1), axis=1)
        candidate = np.where(j == lab, self.pos[:, None],
                             neg_shifted).astype(np.int32)
        if shuffle:
            perm = rng.permutation(n)
            return (self.history[perm], self.history_mask[perm],
                    candidate[perm], label[perm])
        return self.history, self.history_mask, candidate, label

    def _iter(self, news_features, batch_size, epoch, seed, shuffle,
              pad_final):
        hist, mask, cand, label = self.epoch_arrays(epoch, seed, shuffle)
        n = hist.shape[0]
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            if end - start < batch_size and not pad_final:
                continue
            h, c = hist[start:end], cand[start:end]
            if news_features is None:
                batch = {"history_idx": h, "candidate_idx": c}
            else:
                batch = {"history": news_features[h],
                         "candidate": news_features[c]}
            batch.update(history_mask=mask[start:end],
                         label=label[start:end],
                         weight=np.ones(end - start, dtype=np.float32))
            yield {k: _pad_rows(v, batch_size) for k, v in batch.items()}

    def iter_batches(self, news_features: np.ndarray, batch_size: int,
                     epoch: int, seed: int, shuffle: bool = False,
                     pad_final: bool = True) -> Iterator[dict]:
        """Fixed-shape batches of gathered feature rows: history (B,L,F)
        int32, history_mask (B,L) f32, candidate (B,1+K,F) int32, label (B,)
        int32, weight (B,) f32 (0 on the padded rows of a final batch)."""
        return self._iter(news_features, batch_size, epoch, seed, shuffle,
                          pad_final)

    def iter_index_batches(self, batch_size: int, epoch: int, seed: int,
                           shuffle: bool = False,
                           pad_final: bool = True) -> Iterator[dict]:
        """Like iter_batches without the host gather: history_idx (B,L) and
        candidate_idx (B,1+K) int32 news indices, for a gather on the
        device (train/step.py:with_device_gather)."""
        return self._iter(None, batch_size, epoch, seed, shuffle, pad_final)


@dataclasses.dataclass
class EvalSamples:
    """One eval shard (raw behaviors_{r}.tsv lines) as dense arrays:
    candidates padded to a fixed width C with a 0/1 mask, labels from the
    Nxxx-0/1 impression field (reference dataset.py:70-72)."""

    history: np.ndarray         # (N, L) int32
    history_mask: np.ndarray    # (N, L) float32
    candidates: np.ndarray      # (N, C) int32 news indices (0-padded)
    labels: np.ndarray          # (N, C) float32 0/1 (0 on padding)
    candidate_mask: np.ndarray  # (N, C) float32

    @property
    def num_samples(self) -> int:
        return self.history.shape[0]

    @classmethod
    def from_file(cls, path: str, news_index: Dict[str, int], cfg,
                  max_candidates: Optional[int] = None,
                  use_native: bool = True,
                  allow_truncation: bool = False) -> "EvalSamples":
        """Parse one eval shard; candidates padded to ``max_candidates``
        (default: the widest impression). An impression wider than that
        raises CandidateTruncationError; ``allow_truncation=True`` logs a
        warning and drops the excess instead. The native parser runs when
        ``max_candidates`` is given and ``use_native`` is True."""
        t0 = time.perf_counter()
        L = cfg.user_log_length
        if use_native and max_candidates is not None:
            parsed = native_loader.parse_eval_file(path, news_index, L,
                                                   max_candidates)
            if parsed is not None:
                h, m, c, lb, cm, truncated, max_width = parsed
                _guard_truncation(path, truncated, max_width,
                                  max_candidates, allow_truncation)
                out = cls(history=h, history_mask=m, candidates=c,
                          labels=lb, candidate_mask=cm)
                _note("native", path, out.num_samples, t0)
                return out
        hist, mask, cand_lists, label_lists = [], [], [], []

        def parse(parts):
            h, m = pad_to_fix_len(
                trans_to_nindex(parts[3].split(), news_index), L)
            items = parts[4].split()
            labels = [int(i.split("-")[1]) for i in items]
            hist.append(h)
            mask.append(m)
            cand_lists.append(trans_to_nindex(
                [i.split("-")[0] for i in items], news_index))
            label_lists.append(labels)

        _parse_lines(path, 5, parse)
        widths = np.asarray([len(c) for c in cand_lists])
        width = max_candidates or int(widths.max(initial=0))
        n = len(hist)
        _guard_truncation(path, int(np.sum(widths > width)),
                          int(widths.max(initial=0)), width, allow_truncation)
        candidates = np.zeros((n, width), dtype=np.int32)
        labels = np.zeros((n, width), dtype=np.float32)
        cmask = np.zeros((n, width), dtype=np.float32)
        for i, (cl, ll) in enumerate(zip(cand_lists, label_lists)):
            w = min(len(cl), width)
            candidates[i, :w] = cl[:w]
            labels[i, :w] = ll[:w]
            cmask[i, :w] = 1.0
        out = cls(history=_rows(hist, np.int32, L),
                  history_mask=_rows(mask, np.float32, L),
                  candidates=candidates, labels=labels, candidate_mask=cmask)
        _note("python", path, out.num_samples, t0)
        return out

    def iter_batches(self, batch_size: int) -> Iterator[dict]:
        """Fixed-shape eval batches: the arrays' rows, zero-padded to
        batch_size (a padded row has no real candidate, so the metrics
        drop it), and num_real, the count of real rows."""
        n = self.num_samples
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            batch = {k: _pad_rows(getattr(self, k)[start:end], batch_size)
                     for k in ("history", "history_mask", "candidates",
                               "labels", "candidate_mask")}
            batch["num_real"] = end - start
            yield batch
