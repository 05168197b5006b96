"""The port's NAML (models/naml.py, ops/conv.py, utils/init.py's
torch_conv1d) against the JAX package's, on the CPU, at tiny widths, with
params made by the JAX ``naml.init`` from a numpy-made table and bridged
to the port.

Covered: the title CNN against both of JAX's conv lowerings ("xla" and
"taps") in f32 and bf16; the news encoder, the user encoder, forward
(loss and scores) and the gradient of every leaf for both title formats,
every view combination and both user_log_mask settings; id-0 categories,
and categories a test corpus has that the train vocabulary lacks (they
read as id 0 on both sides); the param tree of the port's own init; the
registry. Tolerances: the JAX suite's (f32 rtol 1e-5 / atol 1e-6,
gradients 1e-4 / 1e-5, bf16 5e-2).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.data import build_news_features as jax_features
from newsrecommendation_tpu.data import read_news as jax_read_news
from newsrecommendation_tpu.models import naml as jax_naml
from newsrecommendation_tpu.ops import conv as jax_conv
from newsrecommendation_tpu_torch.bridge import params_from_jax, params_to_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data import build_news_features, read_news
from newsrecommendation_tpu_torch.models import get_model, naml, nrms
from newsrecommendation_tpu_torch.ops import conv1d_same, init_conv1d
from newsrecommendation_tpu_torch.utils import init as pinit

DIMS = dict(model="NAML", num_words_title=6, user_log_length=8,
            word_embedding_dim=16, news_dim=24, news_query_vector_dim=10,
            user_query_vector_dim=10, num_attention_heads=4,
            category_emb_dim=5, npratio=3)
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
VOCAB, DOCS, N_CAT, N_SUB = 30, 12, 4, 6
B = 5
VIEWS = {"none": {}, "category": {"use_category": True},
         "both": {"use_category": True, "use_subcategory": True}}


def cfgs(title_source="word_ids", views="both", **kw):
    kw = {**DIMS, "title_source": title_source, **VIEWS[views], **kw}
    jcfg = JaxConfig(**kw)
    kw.pop("npratio")
    return jcfg, Config(**kw)


def make_params(jcfg, seed=0):
    """JAX init around a numpy-made table (row 0 zero): the word table for
    word_ids, the flattened per-title table for doc_table; bridged."""
    rng = np.random.default_rng(seed)
    if jcfg.title_source == "word_ids":
        shape = (VOCAB, jcfg.word_embedding_dim)
    else:
        shape = (DOCS, jcfg.num_words_title * jcfg.word_embedding_dim)
    table = rng.normal(size=shape).astype(np.float32)
    table[0] = 0.0
    jparams = jax_naml.init(jax.random.PRNGKey(seed), jcfg, table, N_CAT,
                            N_SUB)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def make_features(jcfg, rows, seed=1):
    """(rows, news_feature_width) int32: title columns (a padded tail, row
    0 the unknown news), then category and subcategory ids with 0 among
    them."""
    rng = np.random.default_rng(seed)
    if jcfg.title_source == "word_ids":
        title = rng.integers(0, VOCAB, size=(rows, jcfg.num_words_title))
        title[:, -2:] = 0
    else:
        title = rng.integers(0, DOCS, size=(rows, 1))
    cols = [title]
    if jcfg.use_category:
        cols.append(rng.integers(0, N_CAT + 1, size=(rows, 1)))
    if jcfg.use_subcategory:
        cols.append(rng.integers(0, N_SUB + 1, size=(rows, 1)))
    f = np.concatenate(cols, axis=1).astype(np.int32)
    f[0] = 0
    if jcfg.use_category:
        f[1:3, jcfg.news_feature_width - 1] = 0  # id-0 categories
    return f


def make_batch(jcfg, seed=3):
    rng = np.random.default_rng(seed)
    L, k = jcfg.user_log_length, jcfg.npratio
    feats = make_features(jcfg, 40, seed)
    mask = np.zeros((B, L), np.float32)
    for i, n in enumerate([L, 3, 1, 0, 5]):  # row 3: an empty history
        mask[i, L - n:] = 1.0
    return {
        "history": feats[rng.integers(0, 40, size=(B, L))],
        "history_mask": mask,
        "candidate": feats[rng.integers(0, 40, size=(B, 1 + k))],
        "label": rng.integers(0, 1 + k, size=(B,)).astype(np.int32),
        "weight": np.array([1, 1, 1, 0, 1], np.float32),
    }


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture
def conv_impl():
    """Sets JAX's conv lowering; puts back the one it found."""
    before = jax_conv._CONV_IMPL
    yield jax_conv.set_conv_impl
    jax_conv.set_conv_impl(before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "taps"])
def test_conv1d_same_matches_jax(conv_impl, impl, dtype):
    conv_impl(impl)
    rng = np.random.default_rng(0)
    params = {"w": rng.uniform(-0.2, 0.2, size=(3, 16, 24)).astype(
        np.float32), "b": rng.uniform(-0.2, 0.2, size=24).astype(np.float32)}
    x = rng.normal(size=(7, 6, 16)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jax_conv.conv1d_same(jax.tree.map(jnp.asarray, params), jx)
    got = conv1d_same({k: torch.from_numpy(v) for k, v in params.items()},
                      tx)
    assert got.dtype == tx.dtype and got.shape == (7, 6, 24)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))
    if dtype == "float32":  # SAME padding: the ends see one zero row
        xt = torch.from_numpy(x)
        w = torch.from_numpy(params["w"])
        end = xt[:, -2] @ w[0] + xt[:, -1] @ w[1] + torch.from_numpy(
            params["b"])
        np.testing.assert_allclose(got[:, -1].numpy(), end.numpy(), **F32)


def test_torch_conv1d_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    p = pinit.torch_conv1d(gen, 300, 400, 3)
    bound = 1.0 / math.sqrt(300 * 3)
    assert p["w"].shape == (3, 300, 400) and p["b"].shape == (400,)
    for leaf in p.values():
        assert leaf.dtype == torch.float32
        assert leaf.abs().max() <= bound
        assert leaf.abs().max() > 0.95 * bound  # spans the interval
    assert abs(p["w"].mean().item()) < 0.01 * bound
    q = init_conv1d(torch.Generator().manual_seed(0), 300, 400)
    assert all(torch.equal(q[k], p[k]) for k in p)
    jp = jax_conv.init_conv1d(jax.random.PRNGKey(0), 300, 400, 3)
    assert {k: tuple(v.shape) for k, v in jp.items()} == {
        k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("views", list(VIEWS))
@pytest.mark.parametrize("title_source", ["word_ids", "doc_table"])
def test_news_encoder_matches_jax(title_source, views):
    jcfg, cfg = cfgs(title_source, views)
    jparams, params = make_params(jcfg)
    feats = make_features(jcfg, 9)
    want = jax_naml.news_encoder(jparams, jcfg, jnp.asarray(feats))
    got = naml.news_encoder(params, cfg, torch.from_numpy(feats))
    assert got.shape == (9, cfg.news_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # a title mask pools over the unmasked positions, as in JAX
    if title_source == "word_ids":
        tmask = (feats[:, :cfg.num_words_title] != 0).astype(np.float32)
        want = jax_naml.news_encoder(jparams, jcfg, jnp.asarray(feats),
                                     jnp.asarray(tmask))
        got = naml.news_encoder(params, cfg, torch.from_numpy(feats),
                                torch.from_numpy(tmask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("views", ["none", "both"])
def test_news_encoder_bf16_matches_jax(views):
    jcfg, cfg = cfgs("word_ids", views, compute_dtype="bfloat16")
    jparams, params = make_params(jcfg)
    feats = make_features(jcfg, 9)
    want = jax_naml.news_encoder(jparams, jcfg, jnp.asarray(feats))
    got = naml.news_encoder(params, cfg, torch.from_numpy(feats))
    # the views' params are f32, so with a view the fused vector is f32
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_user_encoder_matches_jax(user_log_mask):
    jcfg, cfg = cfgs(user_log_mask=user_log_mask)
    jparams, params = make_params(jcfg)
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(B, cfg.user_log_length, cfg.news_dim)).astype(
        np.float32)
    mask = make_batch(jcfg)["history_mask"]
    want = jax_naml.user_encoder(jparams, jcfg, jnp.asarray(vecs),
                                 jnp.asarray(mask))
    got = naml.user_encoder(params, cfg, torch.from_numpy(vecs),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if user_log_mask:
        assert (got[3] == 0).all()  # empty history -> zero user vector
    else:
        assert got[3].abs().sum() > 0  # the pad doc stands in


@pytest.mark.parametrize("user_log_mask", [False, True])
@pytest.mark.parametrize("views", list(VIEWS))
@pytest.mark.parametrize("title_source", ["word_ids", "doc_table"])
def test_forward_matches_jax(title_source, views, user_log_mask):
    jcfg, cfg = cfgs(title_source, views, user_log_mask=user_log_mask)
    jparams, params = make_params(jcfg)
    batch = make_batch(jcfg)
    want_loss, want = jax_naml.forward(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True)
    loss, scores = naml.forward(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert scores.shape == (B, 1 + jcfg.npratio)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(loss), float(want_loss), **F32)


@pytest.mark.parametrize("user_log_mask", [False, True])
@pytest.mark.parametrize("views", list(VIEWS))
@pytest.mark.parametrize("title_source", ["word_ids", "doc_table"])
def test_every_gradient_matches_jax(title_source, views, user_log_mask):
    """d loss / d leaf for every leaf against jax.grad: the word table
    trains (word_ids) or stays frozen (doc_table), so the table, the
    category tables and their dense layers, final_attn and pad_doc are
    all held."""
    freeze = title_source == "doc_table"
    jcfg, cfg = cfgs(title_source, views, user_log_mask=user_log_mask,
                     freeze_embedding=freeze)
    jparams, params = make_params(jcfg)
    batch = make_batch(jcfg)
    jgrads = jax.grad(lambda p: jax_naml.forward(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True)[0])(jparams)
    for path, leaf in leaves(params):
        leaf.requires_grad_(not (freeze and path == ("embedding_table",)))
    loss, _ = naml.forward(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    if views != "none":
        assert "final_attn" in params["news_encoder"]
    for path, leaf in leaves(params):
        want = np.asarray(get(jgrads, path))
        if freeze and path == ("embedding_table",):
            assert leaf.grad is None and not want.any()
            continue
        # pad_doc is off the path when user_log_mask: None here, 0 in JAX
        got = (np.zeros_like(want) if leaf.grad is None
               else leaf.grad.numpy())
        np.testing.assert_allclose(got, want, **GRAD, err_msg=str(path))
    if views != "none":  # row 0 of a category table takes no gradient
        assert not params["news_encoder"]["category_emb"].grad[0].any()


def test_unknown_categories_read_as_zero_as_jax(synthetic_dirs):
    """A test corpus's category or subcategory past the train vocabulary
    (here: a vocabulary with half its entries dropped) reads as id 0 on
    both sides, and the encoder gives JAX's vectors for those rows."""
    train_dir, dev_dir = synthetic_dirs
    jcfg, cfg = cfgs("word_ids", "both", filter_num=0)
    train = read_news(os.path.join(train_dir, "news.tsv"), cfg, "train")
    cats = dict(list(train.category_dict.items())[::2])
    subs = dict(list(train.subcategory_dict.items())[::2])
    kw = dict(category_dict=cats, subcategory_dict=subs,
              word_dict=train.word_dict)
    corpus = read_news(os.path.join(dev_dir, "news.tsv"), cfg, "test", **kw)
    jcorpus = jax_read_news(os.path.join(dev_dir, "news.tsv"), jcfg, "test",
                            **kw)
    feats = build_news_features(corpus, cfg)
    np.testing.assert_array_equal(feats, jax_features(jcorpus, jcfg))
    cat_col = feats[1:, cfg.num_words_title:]
    assert (cat_col == 0).any(axis=0).all() and (cat_col > 0).any()
    assert cat_col[:, 0].max() <= max(cats.values())
    rng = np.random.default_rng(0)
    table = rng.normal(size=(len(train.word_dict) + 1, 16)).astype(
        np.float32)
    table[0] = 0.0
    jparams = jax_naml.init(jax.random.PRNGKey(1), jcfg, table,
                            max(cats.values()), max(subs.values()))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    want = jax_naml.news_encoder(jparams, jcfg, jnp.asarray(feats))
    got = naml.news_encoder(params, cfg, torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("views", list(VIEWS))
def test_own_init_builds_the_jax_tree(views):
    """The port's naml.init: JAX's tree and shapes, tables of num + 1 rows
    with row 0 zero, final_attn only with a view, the init laws' bounds,
    and a copy of the caller's table."""
    jcfg, cfg = cfgs("word_ids", views)
    table = np.zeros((VOCAB, cfg.word_embedding_dim), np.float32)
    own = naml.init(cfg, table, num_category=N_CAT,
                    num_subcategory=N_SUB, seed=3, device="cpu")
    jparams = jax.tree.map(np.asarray, jax_naml.init(
        jax.random.PRNGKey(0), jcfg, table, N_CAT, N_SUB))
    flat, tree = jax.tree.flatten(params_to_jax(own))
    jflat, jtree = jax.tree.flatten(jparams)
    assert tree == jtree
    assert [a.shape for a in flat] == [a.shape for a in jflat]
    ne = own["news_encoder"]
    assert ("final_attn" in ne) == (views != "none")
    if views != "none":
        assert ne["category_emb"].shape == (N_CAT + 1, cfg.category_emb_dim)
        assert not ne["category_emb"][0].any()
    bound = 1.0 / math.sqrt(3 * cfg.word_embedding_dim)
    assert ne["cnn"]["w"].abs().max() <= bound
    assert own["user_encoder"]["pad_doc"].abs().max() <= 1.0
    own["embedding_table"] += 1.0
    assert (table == 0).all()


def test_registry_and_init_signature():
    model = get_model("NAML")
    assert (model.init, model.news_encoder, model.user_encoder,
            model.forward) == (naml.init, naml.news_encoder,
                               naml.user_encoder, naml.forward)
    _, cfg = cfgs("word_ids", "none", model="NRMS")
    table = np.zeros((VOCAB, cfg.word_embedding_dim), np.float32)
    a = get_model("NRMS").init(cfg, table, num_category=3,
                               num_subcategory=5, device="cpu")
    b = nrms.init(cfg, table, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a),
                                                            leaves(b)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            naml.init(cfg.replace(model="NAML"), table)


def test_forward_dropout_follows_the_flags():
    jcfg, cfg = cfgs(drop_rate=0.5)
    _, params = make_params(jcfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(jcfg).items()}
    with torch.no_grad():
        plain, _ = naml.forward(params, cfg, batch)
        d1, _ = naml.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
        d2, _ = naml.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(0))
        d3, _ = naml.forward(params, cfg, batch, deterministic=False,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(d1, d2)
    assert not torch.equal(d1, plain) and not torch.equal(d1, d3)
