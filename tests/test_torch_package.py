"""Package-level contract of the PyTorch port: it stands alone (no JAX, no
import of the JAX package), its entry points run on CUDA unless told
otherwise, and the param bridge round-trips."""

import ast
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import newsrecommendation_tpu_torch
from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.models import nrms as jax_nrms
from newsrecommendation_tpu_torch.bridge import params_from_jax, params_to_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.models import get_model, naml, nrms
from newsrecommendation_tpu_torch.serve import Recommender

PKG = pathlib.Path(newsrecommendation_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "newsrecommendation_tpu")


def test_import_leaves_jax_out():
    """Importing every module of the port, in a fresh interpreter, pulls in
    no JAX and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import newsrecommendation_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                              p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(mods), bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, bad = proc.stdout.split(" ", 1)
    assert int(n_mods) >= 16 and bad.strip() == "[]", proc.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = Config(news_dim=8, num_attention_heads=2, word_embedding_dim=4,
                 news_query_vector_dim=4, user_query_vector_dim=4)
    table = np.zeros((5, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nrms.init(cfg, table)
    params = nrms.init(cfg, table, device="cpu")
    feats = np.zeros((3, cfg.news_feature_width), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recommender.from_state(cfg, params, {"N1": 1, "N2": 2}, feats)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(params_to_jax(params))


def test_bridge_round_trips():
    jcfg = JaxConfig(news_dim=8, num_attention_heads=2, word_embedding_dim=4,
                     news_query_vector_dim=4, user_query_vector_dim=4)
    table = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    jparams = jax.tree.map(np.asarray,
                           jax_nrms.init(jax.random.PRNGKey(1), jcfg, table))
    params = params_from_jax(jparams, device="cpu")
    back = params_to_jax(params)
    flat_j, tree_j = jax.tree.flatten(jparams)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree with the same shapes
    own = params_to_jax(nrms.init(Config(**{
        k: getattr(jcfg, k) for k in ("news_dim", "num_attention_heads",
                                      "word_embedding_dim",
                                      "news_query_vector_dim",
                                      "user_query_vector_dim")}),
        table, device="cpu"))
    flat_o, tree_o = jax.tree.flatten(own)
    assert tree_o == tree_j
    assert [a.shape for a in flat_o] == [a.shape for a in flat_j]


def test_config_validation_and_registry():
    with pytest.raises(ValueError):
        Config(news_dim=10, num_attention_heads=3)
    with pytest.raises(ValueError):
        Config(compute_dtype="float16")
    assert Config().dim_per_head == 20
    assert get_model("NRMS").news_encoder is nrms.news_encoder
    assert get_model("NAML").news_encoder is naml.news_encoder
    with pytest.raises(KeyError, match="unknown model"):
        get_model("LSTUR")


def test_register_model_adds_and_gets_back():
    """register_model puts a model under its name, get_model returns it,
    and registering the name again replaces it, as the JAX package's
    register_model does; the registry is restored after."""
    from newsrecommendation_tpu import models as jax_models
    from newsrecommendation_tpu_torch import models

    saved, jax_saved = dict(models.REGISTRY), dict(jax_models.REGISTRY)
    try:
        tiny = models.ModelDef("TINY", nrms.init, nrms.news_encoder,
                               nrms.user_encoder, nrms.forward)
        models.register_model(tiny)
        assert get_model("TINY") is tiny
        again = models.ModelDef("TINY", naml.init, naml.news_encoder,
                                naml.user_encoder, naml.forward)
        models.register_model(again)
        assert get_model("TINY") is again
        assert get_model("NRMS").forward is nrms.forward
        jax_models.register_model(jax_models.ModelDef(
            "TINY", *(getattr(jax_nrms, f) for f in (
                "init", "news_encoder", "user_encoder", "forward"))))
        assert sorted(models.REGISTRY) == sorted(jax_models.REGISTRY)
    finally:
        models.REGISTRY.clear()
        models.REGISTRY.update(saved)
        jax_models.REGISTRY.clear()
        jax_models.REGISTRY.update(jax_saved)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("TINY")
