"""Convert params, and a train state with its Adam moments, between the
JAX package's pytrees and the port.

Both sides hold a nested dict with the same keys, and the port keeps the
JAX package's layouts: Linear weights stay input-major (in, out), as
``ops.common.linear`` reads them, so no transpose is needed. The JAX side
is handed over as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module imports no JAX.

A JAX train state's optimizer state is optax's (train/state.py:
make_optimizer, multi_transform of adam over the trainable leaves and
set_to_zero over the frozen table); its Adam part holds ``count`` and the
moment trees ``mu`` and ``nu``, which ``torch.optim.Adam`` keeps per
trainable leaf as ``step``, ``exp_avg`` and ``exp_avg_sq``. Either the
optax state itself (numpy or JAX leaves) or its flax state dict
(``serialization.to_state_dict``) is taken; the way back gives the state
dict, which ``serialization.from_state_dict`` turns into optax's state.

On a mesh with table shards (parallel/mesh.py) the JAX state's table is
the padded global one (the JAX CLI pads before init): ``state_from_jax``
gives each rank its rows of it and of its moments, and ``state_to_jax``
gathers them back from every rank of the table group.
"""

from __future__ import annotations

import numpy as np
import torch

from newsrecommendation_tpu_torch.utils import resolve_device


def params_from_jax(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def _adam_part(tree):
    """The (count, mu, nu) of the Adam state inside an optax state or its
    state dict."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree["count"], tree["mu"], tree["nu"]
        children = list(tree.values())
    elif all(hasattr(tree, k) for k in ("count", "mu", "nu")):
        return tree.count, tree.mu, tree.nu
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _adam_part(child)
        if found is not None:
            return found
    return None


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_from_jax(params, opt_state, cfg, *, step=None, device="cuda",
                   mesh=None):
    """A JAX train state -> the port's TrainState on ``device``: the params
    bridged, an Adam optimizer over the trainable leaves (as
    train/state.py:make_optimizer builds it, frozen table left out) whose
    per-leaf step is the optax ``count`` and whose moments are ``mu`` and
    ``nu``. ``step``: the state's step counter (default: the count).
    ``mesh``: the rank's state on the mesh's device instead
    (parallel/spmd.py:place_state), its table rows of a sharded table."""
    from newsrecommendation_tpu_torch.train.state import (
        create_train_state,
        trainable_mask,
    )

    if mesh is not None:
        from newsrecommendation_tpu_torch.parallel.spmd import place_state

        whole = state_from_jax(params, opt_state, cfg, step=step,
                               device="cpu")
        return place_state(whole, cfg, mesh)
    state = create_train_state(cfg, params_from_jax(params, device))
    count, mu, nu = _adam_part(opt_state)
    count = int(np.asarray(count))
    mask = trainable_mask(state.params, cfg)
    if count:
        for path, leaf in _paths(state.params):
            if not _at(mask, path):
                continue
            state.optimizer.state[leaf] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.from_numpy(
                    np.array(_at(mu, path), copy=True)).to(leaf.device),
                "exp_avg_sq": torch.from_numpy(
                    np.array(_at(nu, path), copy=True)).to(leaf.device)}
    return state._replace(step=count if step is None else int(step))


def _whole_table(x, mesh):
    """The global rows of a row-sharded leaf, gathered from every rank of
    the table group (a collective: each rank of the group calls it)."""
    import torch.distributed as dist

    if mesh is None or mesh.ts == 1:
        return x.detach()
    parts = [torch.empty_like(x) for _ in range(mesh.ts)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.table_group)
    return torch.cat(parts)


def state_to_jax(state, cfg, mesh=None):
    """The port's TrainState -> (step, params, opt_state) for the JAX
    package: numpy params and the flax state dict of optax's state for
    the same config (``serialization.from_state_dict`` takes it). On a
    ``mesh`` with table shards every rank of a table group calls it
    together and gets the whole state, the table's padded global rows
    gathered from the ranks."""
    from newsrecommendation_tpu_torch.train.state import trainable_mask

    table = state.params.get("embedding_table")
    mask = trainable_mask(state.params, cfg)

    def moments(key):
        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if not _at(mask, path):
                return {}  # optax's MaskedNode for a frozen leaf
            st = state.optimizer.state.get(tree)
            if tree is table:
                v = st[key] if st else torch.zeros_like(tree)
                return _whole_table(v, mesh).cpu().numpy()
            if not st:
                return np.zeros(tuple(tree.shape), np.float32)
            return st[key].detach().cpu().numpy()

        return walk(state.params)

    counts = {float(st["step"]) for st in state.optimizer.state.values()
              if st}
    if len(counts) > 1:
        raise ValueError(f"leaves took different step counts: {counts}")
    count = np.asarray(int(counts.pop()) if counts else 0, np.int32)
    adam = {"count": count, "mu": moments("exp_avg"),
            "nu": moments("exp_avg_sq")}
    opt_state = {"inner_states": {
        "frozen": {"inner_state": {}},
        "train": {"inner_state": {"0": adam, "1": {}}}}}
    params = dict(state.params)
    if table is not None:
        params["embedding_table"] = _whole_table(table, mesh)
    return state.step, params_to_jax(params), opt_state


def params_to_jax(params):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies),
    ready for ``jax.tree.map(jnp.asarray, ...)``."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
