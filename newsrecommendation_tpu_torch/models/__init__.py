"""Model registry: name -> (init, news_encoder, user_encoder, forward)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from newsrecommendation_tpu_torch.models import naml, nrms


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    init: Callable
    news_encoder: Callable
    user_encoder: Callable
    forward: Callable


REGISTRY = {
    "NRMS": ModelDef("NRMS", nrms.init, nrms.news_encoder, nrms.user_encoder,
                     nrms.forward),
    "NAML": ModelDef("NAML", naml.init, naml.news_encoder, naml.user_encoder,
                     naml.forward),
}


def get_model(name: str) -> ModelDef:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")


def register_model(model: ModelDef) -> None:
    """Add ``model`` to the registry under its name (replacing one of the
    same name), where get_model and every entry point that takes a model
    name find it."""
    REGISTRY[model.name] = model
