"""Checkpoint and resume of the train state, with a JSON vocab sidecar.

The JAX package's scheme (newsrecommendation_tpu/ckpt/checkpoint.py) in
the port's own format:
  - ``{model_dir}/{name}``, conventionally ``epoch-{E}[-{step}].ckpt``:
    ``torch.save`` of {"step", "params", "opt_state", "frozen_table_excluded"},
    params as the model's nested dict of tensors and opt_state as
    ``torch.optim.Adam.state_dict()`` (its moments keyed by the position
    of each trainable leaf in train/state.py:make_optimizer's order), all
    on the CPU; read back with ``torch.load(weights_only=True)``.
  - ``{name}.json``: the category, subcategory and word dicts, the
    (always empty) list of sharded leaves and the config's scalar fields,
    under the JAX package's keys.
A frozen title table is not written (it is rebuilt from the data dir and
may have another shape at test time): load takes it from the template.
Both files are written to a temp file and renamed into place, so a killed
run never leaves a torn checkpoint. Restart from the newest checkpoint is
the recovery model (``--load_ckpt_name latest``).

On a mesh (parallel/mesh.py) rank 0 alone writes these two files, as the
reference's rank 0 does (main.py:118-127). A trained table row-sharded
over the ranks is left out of the main file: each rank at data index 0
writes its rows, and their Adam exp_avg / exp_avg_sq, to
``{name}.shards{table_index}.pt``, and the sidecar lists those leaves
under ``sharded_leaves`` (as the JAX package's does). Load reassembles the
global rows from every shard file and keeps the template's share, so a
run resumes at another table_shards, and one card serves the checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
from typing import Optional, Tuple

import torch

TABLE = "embedding_table"
SHARDED_LEAVES = ("params/embedding_table",
                  "opt_state/embedding_table/exp_avg",
                  "opt_state/embedding_table/exp_avg_sq")


def _strip_frozen(params: dict, cfg) -> dict:
    """The param dict with a frozen embedding table replaced by a scalar
    zero: the table is not saved."""
    if not cfg.freeze_embedding or "embedding_table" not in params:
        return params
    out = dict(params)
    out["embedding_table"] = torch.zeros((), dtype=torch.float32)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def snapshot_state(state, cfg) -> dict:
    """The payload of a checkpoint as copies on the state's device: the
    step, the params (the frozen table left out) and the optimizer's state
    dict, every tensor cloned on the current stream. The train step
    updates the live tensors in place; the copies keep their values while
    a writer moves them to the host."""
    with torch.no_grad():
        return {
            "step": int(state.step),
            "params": _map(torch.clone, _strip_frozen(state.params, cfg)),
            "opt_state": _map(torch.clone, state.optimizer.state_dict()),
            "frozen_table_excluded": bool(cfg.freeze_embedding),
        }


def _atomic_write(model_dir: str, path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=model_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _table_slot(state) -> Optional[int]:
    """The table's index in the optimizer's state dict (its position
    among the trainable leaves), or None when it is not trained."""
    table = state.params.get(TABLE)
    leaves = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(leaves):
        if p is table:
            return i
    return None


def _split_table(payload: dict, slot: int):
    """The payload without the table and its moments (scalar zeros in
    their place), and those leaves by their sharded_leaves names."""
    payload = dict(payload, params=dict(payload["params"]))
    shard = {SHARDED_LEAVES[0]: payload["params"][TABLE]}
    payload["params"][TABLE] = torch.zeros((), dtype=torch.float32)
    opt = payload["opt_state"]
    st = opt["state"].get(slot)
    if st:
        st = dict(st)
        for key, name in zip(("exp_avg", "exp_avg_sq"), SHARDED_LEAVES[1:]):
            shard[name] = st[key]
            st[key] = torch.zeros((), dtype=torch.float32)
        payload["opt_state"] = dict(opt, state={**opt["state"], slot: st})
    return payload, shard


def save_checkpoint(model_dir: str, name: str, state, cfg,
                    category_dict=None, subcategory_dict=None,
                    word_dict=None, *, payload: Optional[dict] = None,
                    mesh=None) -> str:
    """Write {model_dir}/{name} and its .json sidecar; returns the path.

    ``state``: a TrainState; ``payload``: a snapshot_state of it taken
    earlier (the background saver's), else one is taken here. ``mesh``:
    every rank calls this at the same point; rank 0 writes the main file
    and the sidecar, and with a trained table sharded over the ranks each
    rank at data index 0 its table shard file. No collective.
    """
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, name)
    if payload is None:
        payload = snapshot_state(state, cfg)
    payload = _map(lambda t: t.cpu(), payload)
    sharded = []
    if mesh is not None and mesh.ts > 1 and not cfg.freeze_embedding:
        payload, shard = _split_table(payload, _table_slot(state))
        sharded = sorted(shard)
        if mesh.data_index == 0:
            rows = shard[SHARDED_LEAVES[0]].shape[0]
            shard.update(offset=mesh.table_index * rows,
                         num_shards=mesh.ts)
            _atomic_write(model_dir, f"{path}.shards{mesh.table_index}.pt",
                          lambda f: torch.save(shard, f))
    if mesh is not None and mesh.rank != 0:
        return path
    _atomic_write(model_dir, path, lambda f: torch.save(payload, f))

    sidecar = {
        "category_dict": category_dict or {},
        "subcategory_dict": subcategory_dict or {},
        "word_dict": word_dict or {},
        "sharded_leaves": sharded,
        "config": {k: v for k, v in vars(cfg).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
    }
    _atomic_write(model_dir, path + ".json",
                  lambda f: f.write(json.dumps(sidecar).encode("utf-8")))
    logging.info("checkpoint saved to %s", path)
    return path


def _copy_into(dst: dict, src: dict, path=()) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst`` in place
    (so the optimizer's references to dst's leaves stay valid)."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint params at {'/'.join(path) or '/'} "
                         f"have keys {sorted(src)}, the model {sorted(dst)}")
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k], path + (k,))
            continue
        if tuple(src[k].shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint leaf {'/'.join(path + (k,))} has shape "
                f"{tuple(src[k].shape)}, the model {tuple(v.shape)}")
        v.copy_(src[k])


def _read_shards(path: str) -> dict:
    """The global (padded) table and moments from every shard file of
    the checkpoint at ``path``, by their sharded_leaves names."""
    def load(i):
        fn = f"{path}.shards{i}.pt"
        if not os.path.exists(fn):
            raise FileNotFoundError(
                f"{path}: its table is sharded but {fn} is missing")
        return torch.load(fn, map_location="cpu", weights_only=True)

    first = load(0)
    shards = [first] + [load(i) for i in range(1, int(first["num_shards"]))]
    rows = first[SHARDED_LEAVES[0]].shape[0]
    if [int(sh["offset"]) for sh in shards] != [
            i * rows for i in range(len(shards))]:
        raise ValueError(f"{path}: the shard files do not tile the table")
    return {name: torch.cat([sh[name] for sh in shards])
            for name in SHARDED_LEAVES if name in first}


def _template_rows(full: torch.Tensor, like: torch.Tensor, mesh):
    """The template's share of global rows: rows [t*r, (t+1)*r) for a
    template of r rows at table index t (0 without a mesh), zero-padded
    past the saved rows. The saved table may differ from the template's
    global rows only by the zero rows of a shard multiple."""
    r = like.shape[0]
    ts = mesh.ts if mesh is not None and mesh.ts > 1 else 1
    total = r * ts
    if (total >= full.shape[0] + ts or tuple(full.shape[1:]) != tuple(
            like.shape[1:]) or bool(full[total:].any())):
        raise ValueError(
            f"checkpoint leaf embedding_table has shape "
            f"{tuple(full.shape)}, the model {(total,) + tuple(like.shape[1:])}")
    start = (mesh.table_index if ts > 1 else 0) * r
    part = full[start:start + r]
    if part.shape[0] < r:
        part = torch.cat([part, part.new_zeros(
            (r - part.shape[0],) + tuple(part.shape[1:]))])
    return part


def load_checkpoint(path: str, state_template, cfg,
                    mesh=None) -> Tuple[object, dict]:
    """Restore a TrainState from ``path`` into the template: its params
    are overwritten in place, its optimizer (built over the same trainable
    leaves, in the same order) takes the saved moments and step counts
    with the template's own hyperparameters, and the step is the saved
    one. A table the checkpoint left out (frozen) is the template's, built
    from the target data dir. A trained table (sharded or not) and its
    moments come in as the template's rows of the global table: the
    rank's share on a ``mesh`` with table shards, else the whole table.
    Returns (state, sidecar dict)."""
    sidecar = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json", "r", encoding="utf-8") as f:
            sidecar = json.load(f)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    saved = dict(blob["params"])
    params = state_template.params
    opt_state = blob["opt_state"]
    if cfg.freeze_embedding:
        saved[TABLE] = params[TABLE]
    else:
        leaves = (_read_shards(path) if sidecar.get("sharded_leaves")
                  else {SHARDED_LEAVES[0]: saved[TABLE]})
        like = params[TABLE]
        saved[TABLE] = _template_rows(leaves[SHARDED_LEAVES[0]], like, mesh)
        slot = _table_slot(state_template)
        st = opt_state["state"].get(slot)
        if st:
            st = dict(st)
            for key, name in zip(("exp_avg", "exp_avg_sq"),
                                 SHARDED_LEAVES[1:]):
                st[key] = _template_rows(leaves.get(name, st[key]), like,
                                         mesh)
            opt_state = dict(opt_state,
                             state={**opt_state["state"], slot: st})
    with torch.no_grad():
        _copy_into(params, saved)
    opt = state_template.optimizer
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    opt.load_state_dict(opt_state)
    for group, h in zip(opt.param_groups, hyper):
        group.update(h)  # the run's lr, not the saved one (as optax)
    state = state_template._replace(step=int(blob["step"]))
    logging.info("checkpoint loaded from %s", path)
    return state, sidecar


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """Newest epoch-{E}[-{step}].ckpt by (epoch, step), or None."""
    if not os.path.isdir(model_dir):
        return None
    best, best_key = None, (-1, -1)
    for fn in os.listdir(model_dir):
        m = re.fullmatch(r"epoch-(\d+)(?:-(\d+))?\.ckpt", fn)
        if m:
            key = (int(m.group(1)), int(m.group(2) or 0))
            if key > best_key:
                best, best_key = fn, key
    return os.path.join(model_dir, best) if best else None
