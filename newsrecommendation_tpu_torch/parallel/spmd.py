"""The data-parallel train step over a (data, table) mesh, one rank each.

Layout, as the JAX package's shard_map step
(newsrecommendation_tpu/parallel/spmd.py):
  - batch: each data index feeds its own rows; the ranks of a table group
    see the same ones;
  - embedding table (and its Adam moments, when it is trained): this
    rank's rows of the zero-padded table (parallel/sharded_embedding.py);
  - every other param and its moments: the same on every rank.

Collectives per step:
  - in every embedding lookup at ts > 1, the row all-reduce over the
    table group (its backward is a local scatter-add);
  - after backward, one flat all-reduce of every trainable gradient over
    the data group, in one bucket (the reference's DDP all-reduce,
    main.py:82);
  - one all-reduce of [loss_sum, weight_sum, hits] over the data group.

The loss is the globally weighted mean: each rank backpropagates
loss_mean x weight_sum of its rows, and the summed gradients are divided
by max(global weight_sum, 1). So padding that lands unevenly on the ranks
gives the single-device math, and an all-padding batch adds nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from newsrecommendation_tpu_torch.models import common
from newsrecommendation_tpu_torch.ops import kernel_config
from newsrecommendation_tpu_torch.parallel.sharded_embedding import (
    gather_rows_sharded,
    local_rows,
)
from newsrecommendation_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
)
from newsrecommendation_tpu_torch.train.step import (
    _dropout_generator,
    with_device_gather,
)

TABLE = "embedding_table"


def table_lookup(mesh):
    """The models' lookup on this mesh: the sharded gather at ts > 1,
    else the dense one."""
    if mesh is not None and mesh.ts > 1:
        return lambda table, ids: gather_rows_sharded(table, ids, mesh)
    return common.default_lookup


def shard_params(params: dict, mesh) -> dict:
    """The rank's params: a copy of every leaf on the mesh's device, the
    embedding table cut to this rank's rows of its padded form."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        leaf = tree.detach()
        if path == (TABLE,) and mesh.ts > 1:
            leaf = local_rows(leaf, mesh.ts, mesh.table_index)
        return leaf.to(mesh.device, copy=True)

    return walk(params)


def _leaf_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path, tree


def place_state(state: TrainState, cfg, mesh) -> TrainState:
    """A train state of whole params (the table unpadded or padded) ->
    this rank's: shard_params, and an optimizer over the new leaves with
    the old one's step counts and moments, the table's cut like the
    table."""
    params = shard_params(state.params, mesh)
    opt = make_optimizer(cfg, params)
    old = dict(_leaf_paths(state.params))
    for path, leaf in _leaf_paths(params):
        st = state.optimizer.state.get(old[path])
        if not st:
            continue
        new = {}
        for key, v in st.items():
            if key in ("exp_avg", "exp_avg_sq"):
                if path == (TABLE,) and mesh.ts > 1:
                    v = local_rows(v, mesh.ts, mesh.table_index)
                v = v.to(mesh.device, copy=True)
            else:
                v = v.clone()
            new[key] = v
        opt.state[leaf] = new
    return TrainState(step=state.step, params=params, optimizer=opt)


def _all_reduce(x, group):
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _spmd_step_body(cfg, model, mesh):
    """(state, batch, base_seed) -> (state, {"loss", "acc"}): the rank's
    forward and backward, the gradient and metric all-reduces over the
    data group, then Adam on the rank's leaves."""
    lookup = table_lookup(mesh)
    shard = mesh.data_index if mesh.dp > 1 else None

    def step(state, batch, base_seed):
        gen = None
        if not cfg.deterministic:
            gen = _dropout_generator(batch["label"].device, base_seed,
                                     state.step, shard)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_mean, scores = model.forward(
            state.params, cfg, batch, generator=gen,
            deterministic=cfg.deterministic, lookup=lookup)
        w = batch["weight"].float()
        wsum = w.sum()
        (loss_mean * wsum).backward()
        hit = (torch.argmax(scores.detach(), dim=-1)
               == batch["label"].long()).float()
        stats = torch.stack([loss_mean.detach() * wsum, wsum,
                             (hit * w).sum()])
        leaves = [p for g in opt.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        bucket = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce(bucket, mesh.data_group)
        _all_reduce(stats, mesh.data_group)
        denom = torch.clamp(stats[1], min=1.0)
        bucket /= denom
        start = 0
        for p, g in zip(leaves, grads):
            p.grad = bucket[start:start + g.numel()].view_as(g)
            start += g.numel()
        opt.step()
        return (state._replace(step=state.step + 1),
                {"loss": stats[0] / denom, "acc": stats[2] / denom})

    return step


def make_spmd_train_step(cfg, model, mesh, device_gather: bool = False):
    """train_step(state, batch, base_seed[, news_feats]) -> (state,
    metrics) on this rank of ``mesh``; the metrics are the global ones,
    equal on every rank. Sets the kernel switches cfg carries."""
    kernel_config.apply(cfg)
    body = _spmd_step_body(cfg, model, mesh)
    return with_device_gather(body) if device_gather else body


def make_spmd_multi_step(cfg, model, mesh, steps_per_call: int,
                         device_gather: bool = False):
    """k spmd steps per call over stacked batches (every tensor with a
    leading axis of k); the per-step metrics stacked."""
    step = make_spmd_train_step(cfg, model, mesh, device_gather)

    def multi_step(state, stacked_batches, base_seed, *news_feats):
        losses, accs = [], []
        for j in range(steps_per_call):
            batch = {k: v[j] for k, v in stacked_batches.items()}
            state, m = step(state, batch, base_seed, *news_feats)
            losses.append(m["loss"])
            accs.append(m["acc"])
        return state, {"loss": torch.stack(losses), "acc": torch.stack(accs)}

    return multi_step


def make_spmd_news_encoder(cfg, model, mesh):
    """encode(params, features) -> news vectors, with the table lookup
    of ``mesh`` (the row all-reduce at ts > 1): phase 1 of evaluation
    over a sharded table never holds the whole table. Every rank of a
    table group must encode the same rows together."""
    lookup = table_lookup(mesh)

    def encode(params, features):
        return model.news_encoder(params, cfg, features, lookup=lookup)

    return encode
