"""Train state: params, the Adam optimizer over the trainable ones, and the
step counter.

The embedding table always lives in the param dict (one code path); when
``cfg.freeze_embedding`` it is left out of the optimizer and takes no
gradient (models/common.py:frozen_table detaches it), which matches the
JAX package's set_to_zero branch and the reference's
nn.Embedding.from_pretrained(freeze=True): the table stays bitwise as it
was. Steps update the params in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrainState(NamedTuple):
    step: int                    # optimizer steps taken, on the host
    params: dict                 # the model's param dict, updated in place
    optimizer: torch.optim.Adam  # over the trainable leaves of params


def trainable_mask(params, cfg):
    """Nested dict of bools: False for leaves left out of optimization."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return not (cfg.freeze_embedding and path[0] == "embedding_table")

    return walk(params)


def _leaves(tree, mask):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], mask[k])]
    return [(tree, mask)]


def make_optimizer(cfg, params) -> torch.optim.Adam:
    """Adam with torch's defaults (b1=0.9, b2=0.999, eps=1e-8), the same
    update as the JAX package's optax.adam, over the trainable leaves;
    marks those as requiring grad and the frozen ones as not."""
    trainable = []
    for leaf, train in _leaves(params, trainable_mask(params, cfg)):
        leaf.requires_grad_(train)
        if train:
            trainable.append(leaf)
    return torch.optim.Adam(trainable, lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(cfg, params) -> TrainState:
    """A state at step 0 over ``params`` (leaf tensors, on the device that
    will train; the state takes them over and updates them in place)."""
    return TrainState(step=0, params=params,
                      optimizer=make_optimizer(cfg, params))
