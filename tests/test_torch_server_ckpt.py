"""Serving from checkpoints on the CPU: Recommender.from_checkpoint,
run_server and POST /reload against the JAX package's on the same
params (each side loading its own checkpoint of them), /reload's 501 and
409, and batches kept on the model they were dispatched to across a
reload."""

import http.client
import json
import threading

import jax
import numpy as np
import pytest

from newsrecommendation_tpu.ckpt import save_checkpoint as jax_save
from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.data import read_news as jax_read_news
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.serve import Recommender as JaxRecommender
from newsrecommendation_tpu.server import run_server as jax_run_server
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu_torch.bridge import state_from_jax
from newsrecommendation_tpu_torch.ckpt import save_checkpoint
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
from newsrecommendation_tpu_torch.serve import Recommender
from newsrecommendation_tpu_torch.server import run_server, serve
from tests.test_torch_cli import one_torch_thread  # noqa: F401

DIMS = dict(model="NRMS", title_source="word_ids", num_words_title=8,
            user_log_length=10, word_embedding_dim=16, news_dim=16,
            num_attention_heads=4, news_query_vector_dim=8,
            user_query_vector_dim=8, filter_num=0, deterministic=True,
            user_log_mask=True, serve_port=0, serve_max_batch=8,
            serve_max_delay_ms=2.0)
F32 = dict(rtol=1e-5, atol=1e-5)


def _call(srv, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    conn.request(method, path,
                 body=None if payload is None else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read().decode())
    conn.close()
    return resp.status, out


def _stop(srv):
    srv.shutdown()
    srv.server_close()
    srv.batcher.close()


@pytest.fixture
def setup(tmp_path):
    """A dev corpus, both configs, and save(seed, name): one set of JAX
    params from PRNGKey(seed), written as a JAX checkpoint into jax/ and,
    bridged, as the port's into port/."""
    data_dir = str(tmp_path / "dev")
    generate_corpus(data_dir, num_news=50, num_users=10, num_impressions=40,
                    seed=5)
    kw = dict(DIMS, mode="serve", test_data_dir=data_dir,
              load_ckpt_name="latest")
    jcfg = JaxConfig(**kw, model_dir=str(tmp_path / "jax"))
    cfg = Config(**kw, model_dir=str(tmp_path / "port"))
    corpus = jax_read_news(f"{data_dir}/news.tsv", jcfg, "train")
    vocabs = dict(category_dict=corpus.category_dict,
                  subcategory_dict=corpus.subcategory_dict,
                  word_dict=corpus.word_dict)
    table = np.random.default_rng(0).normal(
        0, 0.1, size=(len(corpus.word_dict) + 1, 16)).astype(np.float32)

    def save(seed, name):
        jst = jax_state(jcfg, jax_get_model("NRMS").init(
            jax.random.PRNGKey(seed), jcfg, table))
        jax_save(jcfg.model_dir, name, jst, jcfg, **vocabs)
        state = state_from_jax(jax.tree.map(np.asarray, jst.params),
                               jst.opt_state, cfg, device="cpu")
        save_checkpoint(cfg.model_dir, name, state, cfg, **vocabs)

    docs = list(corpus.news_index)
    return dict(cfg=cfg, jcfg=jcfg, save=save, dir=data_dir, vocabs=vocabs,
                hist=docs[:3], cands=docs[3:9])


def test_from_checkpoint_matches_jax(setup):
    setup["save"](0, "epoch-1.ckpt")
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    rec = Recommender.from_checkpoint(f"{cfg.model_dir}/epoch-1.ckpt", cfg,
                                      setup["dir"], device="cpu")
    jrec = JaxRecommender.from_checkpoint(f"{jcfg.model_dir}/epoch-1.ckpt",
                                          jcfg, setup["dir"])
    assert rec.news_index == jrec.news_index and rec.corpus_size == 50
    np.testing.assert_allclose(rec.news_scoring.numpy(),
                               np.asarray(jrec.news_scoring), **F32)
    hists = [setup["hist"], [], ["unknown"] + setup["hist"][:1]]
    cands = [setup["cands"]] * 3
    np.testing.assert_allclose(rec.score_batch(hists, cands),
                               np.asarray(jrec.score_batch(hists, cands)),
                               **F32)
    with pytest.raises(FileNotFoundError):
        Recommender.from_checkpoint(f"{cfg.model_dir}/missing.ckpt", cfg,
                                    setup["dir"], device="cpu")


def test_run_server_from_checkpoint_and_reload(setup):
    """--mode serve: checkpoint + data dir -> a live server on each side
    giving the same scores; a newer checkpoint, picked up by `latest` at
    POST /reload, changes them the same way."""
    cfg, jcfg, req = setup["cfg"], setup["jcfg"], {
        "history": setup["hist"], "candidates": setup["cands"]}
    setup["save"](0, "epoch-1.ckpt")
    srv = run_server(cfg, block=False, device="cpu")
    jsrv = jax_run_server(jcfg, block=False)
    try:
        status, health = _call(srv, "GET", "/healthz")
        assert status == 200 and health["corpus_size"] == 50
        (status, before), (_, jbefore) = (_call(s, "POST", "/score", req)
                                          for s in (srv, jsrv))
        assert status == 200
        np.testing.assert_allclose(before["scores"], jbefore["scores"], **F32)
        assert before["ranked"] == jbefore["ranked"]

        setup["save"](7, "epoch-1-5.ckpt")  # newer by (epoch, step)
        (status, body), (jstatus, jbody) = (_call(s, "POST", "/reload", {})
                                            for s in (srv, jsrv))
        assert status == jstatus == 200 and body == jbody == {
            "status": "reloaded", "corpus_size": 50}
        (_, after), (_, jafter) = (_call(s, "POST", "/score", req)
                                   for s in (srv, jsrv))
        np.testing.assert_allclose(after["scores"], jafter["scores"], **F32)
        assert not np.allclose(after["scores"], before["scores"])
        _, rec = _call(srv, "POST", "/recommend",
                       {"history": setup["hist"], "k": 5})
        _, jrec = _call(jsrv, "POST", "/recommend",
                        {"history": setup["hist"], "k": 5})
        assert rec["doc_ids"] == jrec["doc_ids"]
    finally:
        _stop(srv)
        jsrv.shutdown()
        jsrv.batcher.close()


def test_reload_without_rebuild_source(setup):
    """A server on live params (run_server with a state and its vocabs,
    or serve() without rebuild) has nothing to reload from: 501."""
    setup["save"](0, "epoch-1.ckpt")
    cfg = setup["cfg"]
    rec = Recommender.from_checkpoint(f"{cfg.model_dir}/epoch-1.ckpt", cfg,
                                      setup["dir"], device="cpu")

    class Live:
        params = rec.params

    srv = run_server(cfg, state=Live, vocabs=setup["vocabs"], block=False,
                     device="cpu")
    try:
        status, body = _call(srv, "POST", "/reload", {})
        assert status == 501 and "rebuild" in body["error"]
        _, got = _call(srv, "POST", "/score", {"history": setup["hist"],
                                               "candidates": setup["cands"]})
        np.testing.assert_allclose(
            got["scores"], rec.score(setup["hist"], setup["cands"]), **F32)
    finally:
        _stop(srv)
    srv = serve(rec, port=0, max_batch=4)
    try:
        assert _call(srv, "POST", "/reload", {})[0] == 501
    finally:
        _stop(srv)


def test_reload_conflict_returns_409(setup):
    """While one reload is in flight, another POST /reload gets 409 and
    does not rebuild."""
    setup["save"](0, "epoch-1.ckpt")
    srv = run_server(setup["cfg"], block=False, device="cpu")
    calls = []
    rebuild, srv.rebuild = srv.rebuild, lambda: calls.append(1)
    try:
        assert srv.reload_lock.acquire(blocking=False)
        try:
            status, body = _call(srv, "POST", "/reload", {})
            assert status == 409 and "in flight" in body["error"]
        finally:
            srv.reload_lock.release()
        assert calls == []
        srv.rebuild = rebuild
        assert _call(srv, "POST", "/reload", {})[0] == 200
    finally:
        _stop(srv)


def test_batches_keep_their_model_across_a_reload(setup):
    """/score and /recommend under concurrent load while /reload swaps the
    model: every answer is wholly the old model's or wholly the new one's,
    and once the reload returns, only the new one's."""
    cfg = setup["cfg"]
    setup["save"](0, "epoch-1.ckpt")
    srv = run_server(cfg, block=False, device="cpu")
    old = srv.rec
    setup["save"](7, "epoch-2.ckpt")
    new = Recommender.from_checkpoint(f"{cfg.model_dir}/epoch-2.ckpt", cfg,
                                      setup["dir"], device="cpu")
    hists = [setup["hist"][:i] for i in range(1, 4)]
    want = {name: [r.score(h, setup["cands"]) for h in hists]
            for name, r in (("old", old), ("new", new))}
    got, errors = [], []

    def client(i):
        try:
            for _ in range(6):
                _, body = _call(srv, "POST", "/score",
                                {"history": hists[i % 3],
                                 "candidates": setup["cands"]})
                got.append((i % 3, np.asarray(body["scores"])))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        assert _call(srv, "POST", "/reload", {})[0] == 200
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(got) == 36
        for i, scores in got:
            assert any(np.allclose(scores, want[name][i], **F32)
                       for name in want), scores
        for i, h in enumerate(hists):
            _, body = _call(srv, "POST", "/score",
                            {"history": h, "candidates": setup["cands"]})
            np.testing.assert_allclose(body["scores"], want["new"][i], **F32)
    finally:
        _stop(srv)


def test_naml_checkpoint_saved_resumed_served_and_reloaded(tmp_path):
    """A NAML checkpoint with both category views and a trained word
    table: written by each side from one set of JAX params (the port's
    through bridge.state_from_jax), resumed by the port into a fresh
    cli.init_state sized by the sidecar's vocabularies (one more step
    then agrees with JAX's), loaded by Recommender.from_checkpoint and
    served by run_server against the JAX package's, and after POST
    /reload to a newer checkpoint still equal to JAX's."""
    import torch

    from newsrecommendation_tpu.ckpt import load_checkpoint as jax_load
    from newsrecommendation_tpu.train.step import make_train_step as jstep
    from newsrecommendation_tpu_torch import cli
    from newsrecommendation_tpu_torch.ckpt import load_checkpoint
    from newsrecommendation_tpu_torch.data import build_news_features
    from newsrecommendation_tpu_torch.models import get_model
    from newsrecommendation_tpu_torch.train import make_train_step

    data_dir = str(tmp_path / "dev")
    generate_corpus(data_dir, num_news=50, num_users=10, num_impressions=40,
                    seed=5)
    kw = dict(DIMS, model="NAML", use_category=True, use_subcategory=True,
              category_emb_dim=6, freeze_embedding=False, mode="serve",
              test_data_dir=data_dir, load_ckpt_name="latest", lr=3e-4)
    jcfg = JaxConfig(**kw, model_dir=str(tmp_path / "jax"))
    cfg = Config(**kw, model_dir=str(tmp_path / "port"))
    corpus = jax_read_news(f"{data_dir}/news.tsv", jcfg, "train")
    vocabs = dict(category_dict=corpus.category_dict,
                  subcategory_dict=corpus.subcategory_dict,
                  word_dict=corpus.word_dict)
    n_cat, n_sub = len(corpus.category_dict), len(corpus.subcategory_dict)
    assert n_cat > 1 and n_sub > 1
    table = np.random.default_rng(0).normal(
        0, 0.1, size=(len(corpus.word_dict) + 1, 16)).astype(np.float32)
    table[0] = 0.0

    def save(seed, name):
        jst = jax_state(jcfg, jax_get_model("NAML").init(
            jax.random.PRNGKey(seed), jcfg, table, n_cat, n_sub))
        jax_save(jcfg.model_dir, name, jst, jcfg, **vocabs)
        state = state_from_jax(jax.tree.map(np.asarray, jst.params),
                               jst.opt_state, cfg, device="cpu")
        save_checkpoint(cfg.model_dir, name, state, cfg, **vocabs)
        return jst

    jst = save(0, "epoch-1.ckpt")
    path = f"{cfg.model_dir}/epoch-1.ckpt"

    # resumed: a fresh state of the sidecar's shape takes the checkpoint
    with open(path + ".json") as f:
        sidecar = json.load(f)
    fresh = cli.init_state(cfg, get_model("NAML"), table, "cpu",
                           num_category=len(sidecar["category_dict"]),
                           num_subcategory=len(sidecar["subcategory_dict"]))
    state, _ = load_checkpoint(path, fresh, cfg)
    ne = state.params["news_encoder"]
    assert ne["category_emb"].shape == (n_cat + 1, 6)
    assert ne["subcategory_emb"].shape == (n_sub + 1, 6)
    jst, _ = jax_load(f"{jcfg.model_dir}/epoch-1.ckpt", jst, jcfg)
    rng = np.random.default_rng(1)
    feats = build_news_features(corpus, cfg)
    L, k, b = cfg.user_log_length, jcfg.npratio, 4
    batch = {"history": feats[rng.integers(0, 51, (b, L))],
             "history_mask": (rng.random((b, L)) > 0.3).astype(np.float32),
             "candidate": feats[rng.integers(0, 51, (b, 1 + k))],
             "label": np.zeros(b, np.int32),
             "weight": np.ones(b, np.float32)}
    step_cfg = cfg.replace(deterministic=True)
    state, m = make_train_step(step_cfg, get_model("NAML"))(
        state, {key: torch.from_numpy(v) for key, v in batch.items()}, 0)
    jst, jm = jstep(jcfg.replace(deterministic=True, donate_state=False),
                    jax_get_model("NAML"))(
        jst, {key: jax.numpy.asarray(v) for key, v in batch.items()},
        jax.random.PRNGKey(0))
    assert state.step == int(jst.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        ne["category_dense"]["w"].detach().numpy(),
        np.asarray(jst.params["news_encoder"]["category_dense"]["w"]),
        rtol=5e-4, atol=2e-6)

    # loaded and served, then reloaded
    docs = list(corpus.news_index)
    req = {"history": docs[:3], "candidates": docs[3:9]}
    rec = Recommender.from_checkpoint(path, cfg, data_dir, device="cpu")
    jrec = JaxRecommender.from_checkpoint(f"{jcfg.model_dir}/epoch-1.ckpt",
                                          jcfg, data_dir)
    np.testing.assert_allclose(rec.news_scoring.numpy(),
                               np.asarray(jrec.news_scoring), **F32)
    srv = run_server(cfg, block=False, device="cpu")
    jsrv = jax_run_server(jcfg, block=False)
    try:
        (status, before), (_, jbefore) = (_call(s, "POST", "/score", req)
                                          for s in (srv, jsrv))
        assert status == 200
        np.testing.assert_allclose(before["scores"], jbefore["scores"],
                                   **F32)
        save(7, "epoch-1-5.ckpt")
        for s in (srv, jsrv):
            assert _call(s, "POST", "/reload", {})[0] == 200
        (_, after), (_, jafter) = (_call(s, "POST", "/score", req)
                                   for s in (srv, jsrv))
        np.testing.assert_allclose(after["scores"], jafter["scores"], **F32)
        assert not np.allclose(after["scores"], before["scores"])
    finally:
        _stop(srv)
        jsrv.shutdown()
        jsrv.batcher.close()
