"""The port's NRMS encoders and forward against the JAX package's, on params
made by the JAX ``nrms.init`` and bridged to the port.

The JAX side runs either its plain XLA path (pallas "off") or its Pallas
fused-qkv kernel in interpret mode. Interpret mode alone would also turn
on the fused encoder-tail kernel (ops/pallas/config.py: fused_tail "auto"),
which is not the kernel being ported, so it is switched off there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.models import nrms as jax_nrms
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.models import nrms
from newsrecommendation_tpu_torch.utils import init as pinit

DIMS = dict(num_words_title=6, user_log_length=8, word_embedding_dim=16,
            news_dim=24, news_query_vector_dim=10, user_query_vector_dim=10,
            num_attention_heads=4, npratio=3)
F32 = dict(rtol=1e-5, atol=1e-6)
VOCAB = 50
B = 5


def _cfgs(**kw):
    kw = {**DIMS, **kw}
    jcfg = JaxConfig(**kw)
    kw.pop("npratio")
    return jcfg, Config(**kw)


@pytest.fixture(params=["off", "interpret"])
def jax_mode(request):
    set_pallas_mode(request.param)
    set_fused_tail("off")
    try:
        yield request.param
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")


def _params(jcfg, title_source="word_ids"):
    rng = np.random.default_rng(0)
    rows = VOCAB if title_source == "word_ids" else 12
    width = (jcfg.word_embedding_dim if title_source == "word_ids"
             else jcfg.num_words_title * jcfg.word_embedding_dim)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    table[0] = 0.0
    jparams = jax_nrms.init(jax.random.PRNGKey(0), jcfg, table)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _features(cfg, rows=7, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.title_source == "word_ids":
        f = rng.integers(0, VOCAB, size=(rows, cfg.num_words_title))
        f[:, -2:] = 0  # padded title tail
        f[0] = 0       # the unknown-news row
    else:
        f = rng.integers(0, 12, size=(rows, 1))
        f[0] = 0
    return f.astype(np.int32)


def _history(seed=2):
    rng = np.random.default_rng(seed)
    L = DIMS["user_log_length"]
    vecs = rng.normal(size=(B, L, DIMS["news_dim"])).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    for i, n in enumerate([L, 3, 1, 0, 5]):  # row 3: empty history
        mask[i, L - n:] = 1.0
    return vecs, mask


@pytest.mark.parametrize("title_source", ["word_ids", "doc_table"])
def test_news_encoder_matches_jax(jax_mode, title_source):
    jcfg, cfg = _cfgs(title_source=title_source)
    jparams, params = _params(jcfg, title_source)
    feats = _features(cfg)
    ref = jax_nrms.news_encoder(jparams, jcfg, jnp.asarray(feats))
    out = nrms.news_encoder(params, cfg, torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_news_encoder_bf16_matches_jax(jax_mode):
    jcfg, cfg = _cfgs(compute_dtype="bfloat16")
    jparams, params = _params(jcfg)
    feats = _features(cfg)
    ref = jax_nrms.news_encoder(jparams, jcfg, jnp.asarray(feats))
    out = nrms.news_encoder(params, cfg, torch.from_numpy(feats))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_user_encoder_matches_jax(jax_mode, user_log_mask):
    jcfg, cfg = _cfgs(user_log_mask=user_log_mask)
    jparams, params = _params(jcfg)
    vecs, mask = _history()
    ref = jax_nrms.user_encoder(jparams, jcfg, jnp.asarray(vecs),
                                jnp.asarray(mask))
    out = nrms.user_encoder(params, cfg, torch.from_numpy(vecs),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    if user_log_mask:
        assert (out[3] == 0).all()  # empty history -> zero user vector


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_forward_matches_jax(user_log_mask):
    jcfg, cfg = _cfgs(user_log_mask=user_log_mask)
    jparams, params = _params(jcfg)
    rng = np.random.default_rng(3)
    L, T = DIMS["user_log_length"], DIMS["num_words_title"]
    batch = {
        "history": rng.integers(0, VOCAB, size=(B, L, T)).astype(np.int32),
        "history_mask": _history()[1],
        "candidate": rng.integers(0, VOCAB, size=(B, 1 + jcfg.npratio, T))
        .astype(np.int32),
        "label": rng.integers(0, 1 + jcfg.npratio, size=(B,)).astype(np.int32),
        "weight": np.array([1, 1, 1, 0, 1], np.float32),
    }
    ref_loss, ref_scores = jax_nrms.forward(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True)
    loss, scores = nrms.forward(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), **F32)
    np.testing.assert_allclose(float(loss), float(ref_loss), **F32)


def test_init_laws():
    """The port's own init draws from the JAX package's distributions."""
    _, cfg = _cfgs()
    table = np.zeros((VOCAB, cfg.word_embedding_dim), np.float32)
    p = nrms.init(cfg, table, seed=3, device="cpu")
    wq = p["news_encoder"]["mhsa"]["wq"]
    xavier = np.sqrt(6.0 / (cfg.word_embedding_dim + cfg.news_dim))
    assert wq["w"].shape == (cfg.word_embedding_dim, cfg.news_dim)
    assert float(wq["w"].abs().max()) <= xavier
    assert float(wq["b"].abs().max()) <= 1 / np.sqrt(cfg.word_embedding_dim)
    fc1 = p["user_encoder"]["attn"]["fc1"]["w"]
    assert float(fc1.abs().max()) <= 1 / np.sqrt(cfg.news_dim)
    pad = p["user_encoder"]["pad_doc"]
    assert float(pad.abs().max()) <= 1.0 and float(pad.std()) > 0.3
    again = nrms.init(cfg, table, seed=3, device="cpu")
    assert torch.equal(again["user_encoder"]["pad_doc"], pad)
    emb = pinit.embedding(torch.Generator().manual_seed(0), 400, 8)
    assert (emb[0] == 0).all() and abs(float(emb[1:].std()) - 1.0) < 0.1
