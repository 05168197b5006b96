"""Host-side training loop: epochs over the batch iterator, train steps,
logging with throughput counters, and checkpoints.

As the JAX package's loop: per-epoch iteration, loss/accuracy logging
every log_steps (the only points where they are read to the host, and
where ``metrics.jsonl`` takes a train line), examples/s counted from the
end of the first step, checkpoints every save_steps and at each epoch's
end written by a background thread, an optional profiler trace, and
batches built and copied to the device on a background thread
(train/prefetch.py; cfg.prefetch_depth).

On a mesh (parallel/mesh.py) every rank runs fit over its own data
index's samples with the spmd step; rank 0 alone writes metrics.jsonl
and the main checkpoint file, saves are synchronous, and the collectives
run on the main thread only (the prefetch thread only stages batches).
The ranks agree on the epoch's batch count first (one all-reduce, MAX): a
shard one batch short feeds an all-padding batch (weight 0), which the
globally weighted loss leaves out of the math, since a rank that steps
once more than the others would wait in its all-reduce forever.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from newsrecommendation_tpu_torch.ckpt import save_checkpoint, snapshot_state
from newsrecommendation_tpu_torch.parallel.mesh import barrier
from newsrecommendation_tpu_torch.parallel.spmd import (
    make_spmd_multi_step,
    make_spmd_train_step,
)
from newsrecommendation_tpu_torch.train.prefetch import stage_ahead
from newsrecommendation_tpu_torch.train.step import (
    make_multi_step,
    make_train_step,
)


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _to_device(batch: dict, device) -> dict:
    # A plain copy on the worker's current stream, which is the default
    # stream the step runs on: the copy is ordered after the work queued
    # there and returns when done, so the step never reads a half-copied
    # batch and the allocator never hands its memory to another stream.
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class _AsyncSaver:
    """Checkpoint writes off the training thread.

    The step updates the params and Adam moments in place, so the state is
    first copied on the device (snapshot_state: one clone per tensor on the
    step's stream, ordered after the step that made it and before the next
    one); a single worker thread then copies the snapshot to the host and
    writes it while training goes on. One save in flight at a time, which
    bounds the device memory at twice the state; a failed write is raised
    again at ``wait()``, which fit calls before it returns. On a mesh of
    several ranks the save is synchronous: every rank must have written
    its files before any leaves fit.
    """

    def __init__(self, mesh=None):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = mesh

    def save(self, save_dir, name, state, cfg, **vocabs):
        if self._mesh is not None and not self._mesh.trivial:
            save_checkpoint(save_dir, name, state, cfg, mesh=self._mesh,
                            **vocabs)
            return
        snap = snapshot_state(state, cfg)
        self.wait()

        def _write():
            try:
                save_checkpoint(save_dir, name, state, cfg, payload=snap,
                                **vocabs)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name="ckpt-saver")
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err


def _padding_batch(cfg, news_features, device_gather: bool) -> dict:
    """A batch of cfg.batch_size padding rows (weight 0, all zeros)."""
    b, hist, cand = cfg.batch_size, (cfg.user_log_length,), (1 + cfg.npratio,)
    if device_gather:
        batch = {"history_idx": np.zeros((b,) + hist, np.int32),
                 "candidate_idx": np.zeros((b,) + cand, np.int32)}
    else:
        f = np.asarray(news_features).shape[1:]
        batch = {"history": np.zeros((b,) + hist + f, news_features.dtype),
                 "candidate": np.zeros((b,) + cand + f,
                                       news_features.dtype)}
    batch.update(history_mask=np.zeros((b,) + hist, np.float32),
                 label=np.zeros(b, np.int32), weight=np.zeros(b, np.float32))
    return batch


def agreed_batch_count(samples, batch_size: int, mesh, device) -> int:
    """The epoch's batch count on every rank of ``mesh``: the largest of
    the ranks' own (one all-reduce, MAX); this rank's own without one."""
    own = -(-samples.num_samples // batch_size)
    if mesh is None or mesh.trivial:
        return own
    n = torch.tensor([own], dtype=torch.int64, device=device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    return int(n.item())


def fit(cfg, model, state, samples, news_features, *, mesh=None,
        train_step=None, multi_step=None, vocabs: Optional[dict] = None,
        save_dir: Optional[str] = None,
        device_gather: Optional[bool] = None) -> Dict[str, float]:
    """Train for cfg.epochs over `samples`; returns (state, stats).

    samples: data.loader.TrainSamples; news_features: the combined feature
    matrix. The device is that of the state's params. mesh: this rank's
    place on a (data, table) mesh (parallel/mesh.py); the state is the
    rank's (parallel/spmd.py:place_state), samples its data index's shard,
    and the built-in step the spmd one unless the mesh is trivial.
    train_step /
    multi_step: optional pre-built steps (a custom train_step without a
    multi_step runs one step per call). device_gather: gather feature
    rows on the device from a resident copy of news_features, shipping
    only int32 news indices per step; defaults to cfg.device_gather for
    the built-in step. The kernel switches cfg carries are set where the
    step is built (make_train_step). save_dir: write
    ``epoch-{E}-{step}.ckpt`` every cfg.save_steps steps and
    ``epoch-{E}.ckpt`` at each epoch's end there, with ``vocabs``
    (category_dict, subcategory_dict, word_dict) in their sidecars, and
    append the train log lines to ``metrics.jsonl``. Epochs run from
    cfg.start_epoch; a resumed state carries its step, which seeds the
    dropout draws.
    """
    custom_step = train_step is not None
    if device_gather is None:
        device_gather = not custom_step and bool(cfg.device_gather)
    spmd = mesh is not None and not mesh.trivial
    if train_step is None:
        train_step = (make_spmd_train_step(cfg, model, mesh, device_gather)
                      if spmd else
                      make_train_step(cfg, model, device_gather=device_gather))
    device = _device_of(state.params)
    base_seed = cfg.seed
    vocabs = vocabs or {}
    mlog = None
    if save_dir and (mesh is None or mesh.rank == 0):
        from newsrecommendation_tpu_torch.utils.logging import MetricsLog

        mlog = MetricsLog(os.path.join(save_dir, "metrics.jsonl"))
    saver = _AsyncSaver(mesh)

    total_examples = 0
    total_steps = 0
    t_start = None  # set after the first step: set-up is not throughput
    t0_examples = 0
    prof = None
    if cfg.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    metrics = {"loss": torch.zeros(()), "acc": torch.zeros(())}
    k = cfg.steps_per_call
    if k > 1 and multi_step is None:
        if custom_step:
            logging.warning(
                "steps_per_call=%d ignored: a custom train_step was supplied "
                "without a matching multi_step", k)
            k = 1
        elif spmd:
            multi_step = make_spmd_multi_step(cfg, model, mesh, k,
                                              device_gather)
        else:
            multi_step = make_multi_step(cfg, model, k,
                                         device_gather=device_gather)
    n_batches = agreed_batch_count(samples, cfg.batch_size, mesh, device)
    feats = ()
    if device_gather:
        # one copy for the whole run; every step gathers from it
        feats = (torch.from_numpy(np.asarray(news_features)).to(device),)

    def after_step(ep, cnt, loss_a, acc_a, n_examples):
        """loss_a/acc_a: zero-arg callables returning host floats, called
        only at log points, so other steps never wait for the device."""
        nonlocal total_steps, total_examples, t_start, t0_examples
        total_steps += 1
        total_examples += n_examples
        if cnt % cfg.log_steps == 0:
            loss_v, acc_v = loss_a(), acc_a()
            if t_start is None:
                t_start = time.perf_counter()
                t0_examples = total_examples
            elapsed = max(time.perf_counter() - t_start, 1e-9)
            eps = (total_examples - t0_examples) / elapsed
            logging.info("[%d] Ed: %d, train_loss: %.5f, acc: %.5f, "
                         "ex/s: %.1f", ep, cnt * cfg.batch_size, loss_v,
                         acc_v, eps)
            if mlog is not None:
                mlog.write("train", epoch=ep, step=cnt,
                           loss=round(loss_v, 5), acc=round(acc_v, 5),
                           examples_per_sec=round(eps, 1))
        if save_dir and cnt != 0 and cnt % cfg.save_steps == 0:
            saver.save(save_dir, f"epoch-{ep + 1}-{cnt}.ckpt", state, cfg,
                       **vocabs)

    def iter_host_batches(ep):
        if device_gather:
            own = samples.iter_index_batches(cfg.batch_size, epoch=ep,
                                             seed=cfg.seed)
        else:
            own = samples.iter_batches(news_features, cfg.batch_size,
                                       epoch=ep, seed=cfg.seed)
        n = 0
        for batch in own:
            n += 1
            yield batch
        for _ in range(n, n_batches):  # a short shard pads to the count
            yield _padding_batch(cfg, news_features, device_gather)

    def grouped():
        """All epochs' host batches, k-stacked, with epoch-end markers, in
        one generator: the worker builds epoch N+1's first batches while
        the device still trains on epoch N's tail."""
        for ep in range(cfg.start_epoch, cfg.epochs):
            pending = []
            for batch in iter_host_batches(ep):
                if k == 1:
                    yield "single", ep, [batch]
                    continue
                pending.append(batch)
                if len(pending) == k:
                    yield "stack", ep, pending
                    pending = []
            for batch in pending:  # < k leftovers at epoch end: 1 step each
                yield "single", ep, [batch]
            yield "epoch_end", ep, None

    def stage(item):
        """On the worker thread: stack and copy to the device."""
        kind, ep, batches = item
        if kind == "epoch_end":
            return kind, ep, None, None
        n_examples = [int(b["weight"].sum()) for b in batches]
        if kind == "stack":
            stacked = {key: np.stack([b[key] for b in batches])
                       for key in batches[0]}
            return kind, ep, _to_device(stacked, device), n_examples
        return kind, ep, _to_device(batches[0], device), n_examples

    try:
        cnt = -1
        for kind, ep, dev, n_examples in stage_ahead(
                grouped(), stage, depth=cfg.prefetch_depth):
            if kind == "epoch_end":
                logging.info("epoch %d finished", ep)
                if save_dir:
                    saver.save(save_dir, f"epoch-{ep + 1}.ckpt", state, cfg,
                               **vocabs)
                cnt = -1
                continue
            if kind == "single":
                cnt += 1
                state, metrics = train_step(state, dev, base_seed, *feats)
                after_step(ep, cnt, lambda: float(metrics["loss"]),
                           lambda: float(metrics["acc"]), n_examples[0])
                continue
            state, ms = multi_step(state, dev, base_seed, *feats)
            metrics = {"loss": ms["loss"][-1], "acc": ms["acc"][-1]}
            for j, n in enumerate(n_examples):
                cnt += 1
                after_step(ep, cnt, lambda j=j: float(ms["loss"][j]),
                           lambda j=j: float(ms["acc"][j]), n)
    finally:
        saver.wait()  # the checkpoint files are complete before fit returns
        if prof is not None:
            prof.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(cfg.profile_dir, "trace.json"))

    if spmd:
        barrier(mesh)  # every rank's shard files are written
    final_loss = float(metrics["loss"])  # waits for the last step
    elapsed = (time.perf_counter() - t_start) if t_start else 0.0
    stats = {
        "steps": total_steps,
        "examples": total_examples,
        "examples_per_sec": (
            (total_examples - t0_examples) / elapsed if t_start and elapsed > 0
            else 0.0),
        "final_loss": final_loss,
        "final_acc": float(metrics["acc"]),
    }
    if mlog is not None:
        mlog.write("train_summary",
                   **{k: round(float(v), 5) for k, v in stats.items()})
        mlog.close()
    return state, stats
