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
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
from typing import Optional, Tuple

import torch


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


def save_checkpoint(model_dir: str, name: str, state, cfg,
                    category_dict=None, subcategory_dict=None,
                    word_dict=None, *, payload: Optional[dict] = None) -> str:
    """Write {model_dir}/{name} and its .json sidecar; returns the path.

    ``state``: a TrainState; ``payload``: a snapshot_state of it taken
    earlier (the background saver's), else one is taken here.
    """
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, name)
    if payload is None:
        payload = snapshot_state(state, cfg)
    payload = _map(lambda t: t.cpu(), payload)
    _atomic_write(model_dir, path, lambda f: torch.save(payload, f))

    sidecar = {
        "category_dict": category_dict or {},
        "subcategory_dict": subcategory_dict or {},
        "word_dict": word_dict or {},
        "sharded_leaves": [],
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


def load_checkpoint(path: str, state_template, cfg) -> Tuple[object, dict]:
    """Restore a TrainState from ``path`` into the template: its params
    are overwritten in place, its optimizer (built over the same trainable
    leaves, in the same order) takes the saved moments and step counts
    with the template's own hyperparameters, and the step is the saved
    one. A table the checkpoint left out (frozen) is the template's, built
    from the target data dir. Returns (state, sidecar dict)."""
    sidecar = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json", "r", encoding="utf-8") as f:
            sidecar = json.load(f)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    saved = dict(blob["params"])
    params = state_template.params
    if cfg.freeze_embedding:
        saved["embedding_table"] = params["embedding_table"]
    with torch.no_grad():
        _copy_into(params, saved)
    opt = state_template.optimizer
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    opt.load_state_dict(blob["opt_state"])
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
