"""The train step: forward, backward, Adam update.

One step body serves both entry points: ``make_train_step`` runs it once
per call, ``make_multi_step`` k times in a row per call. Dropout draws
come from a generator on the step's device seeded from (run seed, step
counter), so a k-step call and k single calls follow the same trajectory.
PyTorch runs eagerly: there is nothing to compile, and the params and the
optimizer's moments are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from newsrecommendation_tpu_torch.ops import kernel_config


def weighted_accuracy(labels, scores, weights):
    hit = (torch.argmax(scores, dim=-1) == labels.long()).float()
    w = weights.float()
    return (hit * w).sum() / torch.clamp(w.sum(), min=1.0)


def _dropout_generator(device, seed: int, step: int,
                       shard=None) -> torch.Generator:
    """The generator of one step's dropout masks, on ``device``; ``shard``
    (a data index) gives each data-parallel rank a stream of its own."""
    entropy = [seed, step] + ([] if shard is None else [shard])
    key = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(key[0]))


def _make_step_body(cfg, model):
    """(state, batch, base_seed) -> (state, {"loss", "acc"}), the metrics
    as device scalars (read to the host only by whoever needs them)."""
    def step_body(state, batch, base_seed):
        gen = None
        if not cfg.deterministic:
            gen = _dropout_generator(batch["label"].device, base_seed,
                                    state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss, scores = model.forward(state.params, cfg, batch, generator=gen,
                                     deterministic=cfg.deterministic)
        loss.backward()
        state.optimizer.step()
        acc = weighted_accuracy(batch["label"], scores.detach(),
                                batch["weight"])
        return (state._replace(step=state.step + 1),
                {"loss": loss.detach(), "acc": acc})

    return step_body


def with_device_gather(body):
    """Wrap a step body to gather the news feature rows on the device from
    a resident feature matrix: the batch then carries only history_idx
    (B, L) and candidate_idx (B, 1+K) news indices."""
    def step(state, batch, base_seed, news_feats):
        batch = dict(batch)
        batch["history"] = news_feats[batch.pop("history_idx").long()]
        batch["candidate"] = news_feats[batch.pop("candidate_idx").long()]
        return body(state, batch, base_seed)

    return step


def make_train_step(cfg, model, device_gather: bool = False):
    """train_step(state, batch, base_seed) -> (state, metrics); with
    device_gather, train_step(state, batch, base_seed, news_feats). Sets
    the kernel switches cfg carries (kernel_config.apply) once, here, as
    the JAX package's CLI sets them before it builds its step."""
    kernel_config.apply(cfg)
    body = _make_step_body(cfg, model)
    return with_device_gather(body) if device_gather else body


def make_multi_step(cfg, model, steps_per_call: int,
                    device_gather: bool = False):
    """k sequential train steps per call:
    multi_step(state, stacked_batches, base_seed[, news_feats]) where every
    tensor of stacked_batches has a leading axis of length k. Returns the
    per-step metrics stacked (leading axis k)."""
    step = make_train_step(cfg, model, device_gather=device_gather)

    def multi_step(state, stacked_batches, base_seed, *news_feats):
        losses, accs = [], []
        for j in range(steps_per_call):
            batch = {k: v[j] for k, v in stacked_batches.items()}
            state, m = step(state, batch, base_seed, *news_feats)
            losses.append(m["loss"])
            accs.append(m["acc"])
        return state, {"loss": torch.stack(losses), "acc": torch.stack(accs)}

    return multi_step
