"""Serving front end: micro-batching + HTTP API over Recommender.

- **Micro-batching** (:class:`BatchingScorer`): concurrent requests are
  coalesced into one padded device batch, so the card runs one batched
  user-encode and scoring pass per batch instead of one per user.
- **Shape bucketing**: request batches are padded up to a small fixed set
  of (batch, candidate-width) buckets, so the kernels and matmuls see a
  handful of shapes.
- **HTTP API** (:func:`serve`): a stdlib ThreadingHTTPServer with JSON
  endpoints: ``POST /score`` (rank a candidate list), ``POST /recommend``
  (corpus-wide top-k), ``POST /reload`` (rebuild from the newest
  checkpoint and swap it in), ``GET /healthz``, ``GET /stats``. One thread
  per connection feeds the shared batcher, so concurrency turns into
  device batch size.

CLI: ``python -m newsrecommendation_tpu_torch.cli --mode serve
--load_ckpt_name latest --serve_port 8000``.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket caps n)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class _Request:
    kind: str                       # "score" | "recommend"
    history: Sequence[str]
    candidates: Optional[Sequence[str]] = None   # score only
    k: int = 0                                   # recommend only
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


class ServerStats:
    """Thread-safe counters for the /stats endpoint."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_requests = 0
        self.max_batch_seen = 0
        self.errors = 0

    def record_batch(self, n: int):
        with self._lock:
            self.batches += 1
            self.batched_requests += n
            self.max_batch_seen = max(self.max_batch_seen, n)

    def record_request(self):
        with self._lock:
            self.requests += 1

    def record_error(self):
        with self._lock:
            self.errors += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            mean = (self.batched_requests / self.batches
                    if self.batches else 0.0)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_batch_size": round(mean, 2),
                "max_batch_size": self.max_batch_seen,
                "errors": self.errors,
            }


class BatchingScorer:
    """Coalesces concurrent score/recommend requests into device batches.

    A single worker thread drains the queue: it blocks for the first
    request, then waits up to ``max_delay_ms`` (or until ``max_batch``
    requests are pending) before dispatching, grouping requests by
    (kind, shape bucket) into one padded device call per group. Each
    caller blocks on its request's event and gets exactly its own rows
    back, so results are identical to unbatched calls (row-wise scoring is
    batch-invariant: user encoding and dot-product scoring have no
    cross-row interaction).

    ``close()`` waits ``close_join_s`` for the worker, and with a pipeline
    up to ``close_grace_s`` more while it hands over its last batch. A
    worker still busy then is wedged: every request not yet answered
    fails with a RuntimeError before the completer stops.
    """

    def __init__(self, rec, max_batch: int = 64, max_delay_ms: float = 2.0,
                 cand_buckets: Sequence[int] = (8, 32, 128, 384),
                 k_buckets: Sequence[int] = (16, 128),
                 stats: Optional[ServerStats] = None,
                 pipeline_depth: int = 2, close_join_s: float = 5.0,
                 close_grace_s: float = 30.0):
        self.rec = rec
        self.close_join_s = float(close_join_s)
        self.close_grace_s = float(close_grace_s)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        # Two batch tiers only: 1 (single-request latency path) and
        # max_batch (everything else, padded), so the device sees a handful
        # of shapes whatever the load.
        self.batch_buckets = ([1, self.max_batch] if self.max_batch > 1
                              else [1])
        self.cand_buckets = tuple(sorted(cand_buckets))
        self.k_buckets = tuple(sorted(k_buckets))
        self.stats = stats or ServerStats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        # every submitted request until its caller has its answer
        self._pending_lock = threading.Lock()
        self._pending: Dict[int, _Request] = {}
        # Dispatch/completion pipeline: the collector thread encodes and
        # QUEUES each device batch (CUDA work is asynchronous: the call
        # returns device tensors at once), then hands (reqs, device_out) to
        # the completer, which blocks on the copy to the host and
        # distributes rows. With `pipeline_depth` batches in flight,
        # collection and encoding of batch N+1 overlap batch N's device
        # work. depth 0 is the synchronous path.
        self.pipeline_depth = int(pipeline_depth)
        self._done_q: Optional["queue.Queue"] = None
        self._completer = None
        if self.pipeline_depth > 0:
            self._done_q = queue.Queue(maxsize=self.pipeline_depth)
            self._completer = threading.Thread(
                target=self._complete_loop, daemon=True,
                name="batching-scorer-completer")
            self._completer.start()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="batching-scorer")
        self._worker.start()

    # ---- public API (thread-safe, blocking) ------------------------------

    @property
    def max_candidates(self) -> int:
        return self.cand_buckets[-1]

    def score(self, history: Sequence[str],
              candidates: Sequence[str]) -> np.ndarray:
        """(len(candidates),) scores; blocks until the batch executes."""
        candidates = list(candidates)
        if len(candidates) > self.max_candidates:
            raise ValueError(
                f"{len(candidates)} candidates exceeds the largest shape "
                f"bucket ({self.max_candidates}); split the request")
        req = _Request("score", history, candidates=candidates)
        return self._submit(req)

    def recommend(self, history: Sequence[str], k: int = 10):
        """(doc_ids, scores) top-k over the whole corpus."""
        k = int(k)
        if k > self.k_buckets[-1]:
            raise ValueError(f"k={k} exceeds the largest top-k bucket "
                             f"({self.k_buckets[-1]})")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        req = _Request("recommend", history, k=k)
        return self._submit(req)

    def close(self):
        self._stop.set()
        # unblock the worker's queue.get
        self._q.put(_Request("stop", []))
        self._worker.join(timeout=self.close_join_s)
        if self._completer is not None:
            # The worker may still be putting an in-flight batch into the
            # bounded _done_q; the completer drains it, so wait a while
            # longer for the worker to exit.
            deadline = time.monotonic() + self.close_grace_s
            while self._worker.is_alive() and time.monotonic() < deadline:
                self._worker.join(timeout=0.5)
        if self._worker.is_alive():
            # wedged: a sentinel now could overtake its batch and leave
            # that batch's callers without an answer, so fail them first
            with self._pending_lock:
                stranded = [r for r in self._pending.values()
                            if not r.done.is_set()]
            logging.warning("BatchingScorer.close: the worker is still busy "
                            "after %.1f s; failing %d request(s) in flight",
                            self.close_join_s + (self.close_grace_s
                                                 if self._completer else 0),
                            len(stranded))
            for r in stranded:
                r.error = RuntimeError(
                    "BatchingScorer closed with the batch in flight")
                r.done.set()
        if self._completer is not None:
            # FIFO: the sentinel lands after any batches handed over, so
            # their callers still get results before the completer exits
            try:
                self._done_q.put(None, timeout=self.close_join_s)
            except queue.Full:
                logging.warning("BatchingScorer.close: the completer is "
                                "busy; leaving it to exit with the process")
            self._completer.join(timeout=self.close_join_s)
        # fail anything enqueued after the worker's own drain (the
        # _submit liveness re-check unblocks those callers regardless,
        # but deliver a clean error where possible)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req.kind != "stop":
                req.error = RuntimeError("BatchingScorer closed")
                req.done.set()

    def _submit(self, req: _Request):
        if self._stop.is_set():
            raise RuntimeError("BatchingScorer is closed")
        self.stats.record_request()
        with self._pending_lock:
            self._pending[id(req)] = req
        try:
            self._q.put(req)
            # periodic liveness re-check: a request enqueued in the window
            # between close()'s stop flag and the worker's final drain
            # would otherwise block its caller forever
            while not req.done.wait(timeout=0.5):
                if (self._stop.is_set() and not self._worker.is_alive()
                        and (self._completer is None
                             or not self._completer.is_alive())):
                    raise RuntimeError("BatchingScorer closed mid-request")
        finally:
            with self._pending_lock:
                del self._pending[id(req)]
        if req.error is not None:
            raise req.error
        return req.result

    # ---- worker ----------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first.kind == "stop":
                break
            batch = [first]
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt.kind == "stop":
                    self._stop.set()
                    break
                batch.append(nxt)
            self._dispatch(batch)
        # drain: fail any stragglers so callers don't hang
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req.kind != "stop":
                req.error = RuntimeError("BatchingScorer closed")
                req.done.set()

    def _dispatch(self, batch: List[_Request]):
        groups: Dict[tuple, List[_Request]] = {}
        for r in batch:
            if r.kind == "score":
                key = ("score",
                       next_bucket(max(1, len(r.candidates)),
                                   self.cand_buckets))
            else:
                key = ("recommend", next_bucket(max(1, r.k), self.k_buckets))
            groups.setdefault(key, []).append(r)
        for (kind, width), reqs in groups.items():
            try:
                if kind == "score":
                    item = self._dispatch_score(reqs, width)
                else:
                    item = self._dispatch_recommend(reqs, width)
            except BaseException as e:  # deliver, don't kill the worker
                self.stats.record_error()
                for r in reqs:
                    r.error = e
                    r.done.set()
                continue
            if self._done_q is None:
                self._complete(item)
            else:
                self._done_q.put(item)  # bounded: backpressure on dispatch

    def _pad_requests(self, reqs: List[_Request]):
        """Pad the request list itself up to a batch bucket (repeat row 0)."""
        n = len(reqs)
        bb = next_bucket(n, self.batch_buckets)
        return n, bb

    def _dispatch_score(self, reqs: List[_Request], cand_width: int):
        n, bb = self._pad_requests(reqs)
        hists = [r.history for r in reqs] + [[]] * (bb - n)
        cands = ([list(r.candidates)[:cand_width] for r in reqs]
                 + [[]] * (bb - n))
        self.stats.record_batch(n)
        # the whole batch runs against one rec, read once: a /reload swap
        # of self.rec in between must not split it between two models
        rec = self.rec
        out = rec.score_batch_async(hists, cands, max_candidates=cand_width)
        return "score", reqs, out

    def _dispatch_recommend(self, reqs: List[_Request], k_width: int):
        n, bb = self._pad_requests(reqs)
        hists = [r.history for r in reqs] + [[]] * (bb - n)
        self.stats.record_batch(n)
        # pin the rec the batch was DISPATCHED against: a swap of self.rec
        # between dispatch and completion must not remap the in-flight
        # top-k indices with another corpus's _inv_index
        rec = self.rec
        scores, idx = rec.recommend_batch_async(hists, k=k_width)
        return "recommend", reqs, (rec, scores, idx)

    def _complete(self, item):
        """Blocking half: fetch device results, distribute rows, wake
        callers. Runs on the completer thread when pipelining."""
        kind, reqs, out = item
        try:
            if kind == "score":
                host = out.float().cpu().numpy()
                for i, r in enumerate(reqs):
                    r.result = host[i][: len(r.candidates)].copy()
                    r.done.set()
            else:
                rec, scores, idx = out
                ids, scores = rec.finish_recommend_batch(scores, idx)
                for i, r in enumerate(reqs):
                    r.result = (ids[i][: r.k], scores[i][: r.k])
                    r.done.set()
        except BaseException as e:  # deliver, don't kill the completer
            self.stats.record_error()
            for r in reqs:
                r.error = e
                r.done.set()

    def _complete_loop(self):
        while True:
            item = self._done_q.get()
            if item is None:  # close() sentinel
                break
            self._complete(item)


def _warm_buckets(rec, batcher: BatchingScorer) -> None:
    """Run the batch tiers of the smallest candidate bucket AND the
    smallest top-k bucket on `rec` once, so the first real /score or
    /recommend does not stall behind one-time set-up (the kernel build,
    CUDA library initialisation) inside the single BatchingScorer worker,
    where it would block all concurrent traffic."""
    c0 = batcher.cand_buckets[0]
    rec.score_batch([["warmup"]], [["warmup"]], max_candidates=c0)
    if batcher.max_batch > 1:
        rec.score_batch([["warmup"]] * batcher.max_batch,
                        [["warmup"]] * batcher.max_batch,
                        max_candidates=c0)
    k0 = batcher.k_buckets[0]
    rec.recommend_batch([["warmup"]], k=k0)
    if batcher.max_batch > 1:
        rec.recommend_batch([["warmup"]] * batcher.max_batch, k=k0)


class _Handler(BaseHTTPRequestHandler):
    # set by serve(): batcher, rec, started
    server_version = "newsrec-torch/1.0"
    # HTTP/1.1 keep-alive: without it every response closes the TCP
    # connection and clients pay a reconnect per request (safe here:
    # _json always sends Content-Length)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logging.debug("http: " + fmt, *args)

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # client gave up while its batch was in flight — nothing to do
            logging.debug("client disconnected before response")

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        if n <= 0:
            return {}
        return json.loads(self.rfile.read(n).decode())

    def do_GET(self):
        if self.path == "/healthz":
            rec = self.server.rec  # type: ignore[attr-defined]
            self._json(200, {
                "status": "ok",
                "model": rec.cfg.model,
                "corpus_size": rec.corpus_size,
            })
        elif self.path == "/stats":
            self._json(200,
                       self.server.batcher.stats.snapshot())  # type: ignore
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _reload(self, batcher) -> None:
        """Rebuild a Recommender from the rebuild source, run its batch
        tiers once, then swap it into the batcher: batches already
        dispatched finish on the old one, later ones score on the new."""
        rebuild = self.server.rebuild  # type: ignore[attr-defined]
        if rebuild is None:
            self._json(501, {"error": "no rebuild source configured (server "
                                      "started from a live Recommender, "
                                      "not a checkpoint)"})
            return
        # one reload at a time; a second one gets 409 rather than a wait
        lock = self.server.reload_lock  # type: ignore[attr-defined]
        if not lock.acquire(blocking=False):
            self._json(409, {"error": "a reload is already in flight"})
            return
        try:
            new_rec = rebuild()
            _warm_buckets(new_rec, batcher)
            batcher.rec = new_rec
            self.server.rec = new_rec  # type: ignore[attr-defined]
        finally:
            lock.release()
        self._json(200, {"status": "reloaded",
                         "corpus_size": new_rec.corpus_size})

    def do_POST(self):
        batcher = self.server.batcher  # type: ignore[attr-defined]
        try:
            req = self._read_json()
            if self.path == "/reload":
                self._reload(batcher)
                return
            history = req.get("history", [])
            if not isinstance(history, list):
                raise ValueError("history must be a list of doc-id strings")
            if self.path == "/score":
                candidates = req.get("candidates", [])
                if not isinstance(candidates, list) or not candidates:
                    raise ValueError("candidates must be a non-empty list "
                                     "of doc-id strings")
                scores = batcher.score(history, candidates)
                order = np.argsort(-scores, kind="stable")
                self._json(200, {
                    "scores": [float(s) for s in scores],
                    "ranked": [candidates[i] for i in order],
                })
            elif self.path == "/recommend":
                k = int(req.get("k", 10))
                ids, scores = batcher.recommend(history, k)
                self._json(200, {
                    "doc_ids": list(ids),
                    "scores": [float(s) for s in scores],
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # pragma: no cover - defensive
            logging.exception("serving error")
            self._json(500, {"error": str(e)})


class _Server(ThreadingHTTPServer):
    # default request_queue_size (5) drops connections under a burst of
    # concurrent clients (measured: ConnectionResetError at 64 clients)
    request_queue_size = 128
    daemon_threads = True


def serve(rec, host: str = "127.0.0.1", port: int = 8000,
          max_batch: int = 64, max_delay_ms: float = 2.0,
          warmup: bool = True, rebuild=None,
          pipeline_depth: int = 2) -> ThreadingHTTPServer:
    """Start the HTTP recommender service on ``rec``'s device; returns the
    (started) server. ``port=0`` takes a free port
    (``srv.server_address[1]``).

    The caller owns shutdown: ``srv.shutdown(); srv.server_close();
    srv.batcher.close()``. ``warmup=True`` runs both batch tiers once
    before the first request (see _warm_buckets). ``rebuild``: a zero-arg
    callable returning a fresh Recommender, which enables ``POST /reload``
    (``srv.reload_lock`` held means a reload is in flight).
    """
    batcher = BatchingScorer(rec, max_batch=max_batch,
                             max_delay_ms=max_delay_ms,
                             pipeline_depth=pipeline_depth)
    if warmup:
        _warm_buckets(rec, batcher)
        batcher.score(["warmup"], ["warmup"])  # and the batcher path itself
    srv = _Server((host, port), _Handler)
    srv.rec = rec                    # type: ignore[attr-defined]
    srv.batcher = batcher            # type: ignore[attr-defined]
    srv.rebuild = rebuild            # type: ignore[attr-defined]
    srv.reload_lock = threading.Lock()  # type: ignore[attr-defined]
    if rebuild is not None and host not in ("127.0.0.1", "localhost", "::1"):
        logging.warning(
            "serving on non-loopback %s with /reload enabled: the reload "
            "endpoint is unauthenticated; front it with an authenticating "
            "proxy or bind to 127.0.0.1", host)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="newsrec-http")
    t.start()
    logging.info("serving on http://%s:%d (max_batch=%d, max_delay=%.1fms)",
                 host, srv.server_address[1], max_batch, max_delay_ms)
    return srv


def run_server(cfg, state=None, vocabs: Optional[dict] = None,
               block: bool = True, *, device="cuda"):
    """CLI entry: build a Recommender on ``device`` and serve it.

    With ``state`` and ``vocabs`` (fresh from run_train in the same
    process) the live params serve cfg.test_data_dir's corpus, and
    /reload has no source (501). Otherwise the checkpoint
    cfg.load_ckpt_name in cfg.model_dir ("latest" or none: the newest,
    resolved again at every /reload, so a reload picks up a newer
    checkpoint) serves it. ``block=False`` returns the started server
    instead of serving until interrupted."""
    import os

    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    serve_kw = dict(scorer=cfg.serve_scorer, device=dev,
                    cache_dtype=(None if cfg.serve_cache_dtype == "float32"
                                 else cfg.serve_cache_dtype))
    rebuild = None
    if state is not None and vocabs is not None:
        from newsrecommendation_tpu_torch.cli import build_embedding_table
        from newsrecommendation_tpu_torch.data import (
            build_news_features,
            read_news,
        )

        corpus = read_news(os.path.join(cfg.test_data_dir, "news.tsv"), cfg,
                           "test", **vocabs)
        params = state.params
        if cfg.title_source == "doc_table":
            # the frozen per-title table is the serving corpus's own
            params = dict(params)
            params["embedding_table"] = torch.as_tensor(
                build_embedding_table(cfg, cfg.test_data_dir, corpus),
                dtype=torch.float32)
        rec = Recommender.from_state(cfg, params, corpus.news_index,
                                     build_news_features(corpus, cfg),
                                     **serve_kw)
    else:
        from newsrecommendation_tpu_torch.cli import checkpoint_path

        def rebuild():
            return Recommender.from_checkpoint(
                checkpoint_path(cfg), cfg, cfg.test_data_dir, **serve_kw)

        rec = rebuild()
    srv = serve(rec, host=cfg.serve_host, port=cfg.serve_port,
                max_batch=cfg.serve_max_batch,
                max_delay_ms=cfg.serve_max_delay_ms, rebuild=rebuild,
                pipeline_depth=cfg.serve_pipeline_depth)
    if not block:
        return srv
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()  # type: ignore[attr-defined]
