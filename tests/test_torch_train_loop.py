"""The port's training loop (fit) on the CPU: end to end from a synthetic
corpus through prepare_training_data and TrainSamples, against the JAX
package's fit on the same params and data with dropout off, and the
loop's own guarantees (prefetch and the device gather change nothing,
k steps per call with leftovers, checkpoints written, profiler traces)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.data.loader import TrainSamples as JaxSamples
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.loop import fit as jax_fit
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data import (
    build_news_features,
    random_word_embeddings,
    read_news,
)
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.data.prepare import prepare_training_data
from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
from newsrecommendation_tpu_torch.models import get_model, nrms
from newsrecommendation_tpu_torch.train import create_train_state, fit


def port_cfg(jcfg, **kw):
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{n: getattr(jcfg, n) for n in names}).replace(**kw)


def tiny_samples(cfg, n, vocab=30):
    r = np.random.default_rng(0)
    arrays = dict(
        history=r.integers(0, vocab, size=(n, cfg.user_log_length)).astype(
            np.int32),
        history_mask=(r.random((n, cfg.user_log_length)) > 0.2).astype(
            np.float32),
        pos=r.integers(1, vocab, size=(n,)).astype(np.int32),
        neg=r.integers(1, vocab, size=(n, cfg.npratio)).astype(np.int32))
    feats = np.concatenate(
        [np.zeros((1, cfg.news_feature_width), np.int32),
         r.integers(0, vocab, size=(vocab - 1, cfg.news_feature_width))
         .astype(np.int32)])
    return arrays, feats


def jax_params(jcfg, vocab=30):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(vocab, jcfg.word_embedding_dim)).astype(
        np.float32)
    table[0] = 0
    return jax_get_model("NRMS").init(jax.random.PRNGKey(0), jcfg, table)


def port_fit(cfg, jparams, arrays, feats, **kw):
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    state = create_train_state(cfg, params)
    return fit(cfg, get_model("NRMS"), state, TrainSamples(**arrays), feats,
               **kw)


def flat(params):
    if isinstance(params, dict):
        return [x for k in params for x in flat(params[k])]
    return [params]


def test_fit_matches_jax_fit(tiny_cfg):
    """Two epochs with dropout off: the same steps, examples and, within
    the f32 noise of two frameworks, the same final loss and accuracy."""
    jcfg = tiny_cfg.replace(epochs=2, log_steps=3, deterministic=True,
                            lr=3e-3, freeze_embedding=True,
                            donate_state=False)
    cfg = port_cfg(jcfg)
    arrays, feats = tiny_samples(cfg, n=4 * cfg.batch_size + 1)
    jparams = jax_params(jcfg)
    _, jstats = jax_fit(jcfg, jax_get_model("NRMS"),
                        jax_state(jcfg, jparams), JaxSamples(**arrays), feats)
    state, stats = port_fit(cfg, jparams, arrays, feats)
    assert set(stats) == set(jstats)
    assert stats["steps"] == jstats["steps"] == 10 and state.step == 10
    assert stats["examples"] == jstats["examples"] == 2 * (4 * 4 + 1)
    assert stats["examples_per_sec"] > 0
    np.testing.assert_allclose(stats["final_loss"], jstats["final_loss"],
                               rtol=1e-4)
    assert stats["final_acc"] == pytest.approx(jstats["final_acc"], abs=1e-6)


@pytest.mark.parametrize("change", [dict(prefetch_depth=0),
                                    dict(device_gather=False),
                                    dict(steps_per_call=3)])
def test_fit_trajectory_unchanged_by_staging(tiny_cfg, change):
    """Prefetch depth, the device gather and k steps per call change
    nothing in the trajectory, dropout on: params bit for bit."""
    cfg = port_cfg(tiny_cfg, epochs=2, log_steps=3, drop_rate=0.2,
                   prefetch_depth=3)
    arrays, feats = tiny_samples(cfg, n=7 * cfg.batch_size + 1)
    jparams = jax_params(tiny_cfg)
    base, base_stats = port_fit(cfg, jparams, arrays, feats)
    other, stats = port_fit(cfg.replace(**change), jparams, arrays, feats)
    assert stats["steps"] == base_stats["steps"] == 16
    assert stats["examples"] == base_stats["examples"] == 2 * 29
    assert stats["final_loss"] == base_stats["final_loss"]
    for a, b in zip(flat(base.params), flat(other.params)):
        assert torch.equal(a, b)


def test_fit_end_to_end_from_a_corpus(tmp_path, tiny_cfg):
    """corpus -> prepared shard -> TrainSamples -> fit, at tiny widths with
    dropout: finite losses, params moved, frozen table untouched, and a
    profiler trace written."""
    cfg = port_cfg(tiny_cfg, epochs=2, log_steps=5, drop_rate=0.2,
                   freeze_embedding=True, lr=3e-3, batch_size=8,
                   profile_dir=str(tmp_path / "trace"))
    data = tmp_path / "train"
    generate_corpus(str(data), num_news=60, num_users=20, num_impressions=40,
                    title_len=cfg.num_words_title, seed=1)
    n = prepare_training_data(str(data), 1, cfg.npratio, cfg.seed)
    corpus = read_news(str(data / "news.tsv"), cfg)
    samples = TrainSamples.from_file(
        str(data / f"behaviors_np{cfg.npratio}_0.tsv"), corpus.news_index,
        cfg)
    assert samples.num_samples == n
    table = random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim)
    params = nrms.init(cfg, table, seed=0, device="cpu")
    before = [p.clone() for p in flat(params)]
    state, stats = fit(cfg, get_model("NRMS"), create_train_state(cfg,
                                                                  params),
                       samples, build_news_features(corpus, cfg))
    assert stats["steps"] == 2 * -(-n // cfg.batch_size)
    assert stats["examples"] == 2 * n and np.isfinite(stats["final_loss"])
    moved = [not torch.equal(a, b) for a, b in zip(before, flat(params))]
    assert not moved[0] and sum(moved) == len(moved) - 1  # table frozen
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_fit_save_dir_waits_for_the_checkpoint_slice(tiny_cfg, tmp_path):
    """The checkpoint slice has landed: fit(save_dir=...) writes each
    epoch's checkpoint with its vocab sidecar and the metrics lines
    (tests/test_torch_ckpt.py holds their contents)."""
    cfg = port_cfg(tiny_cfg, epochs=2)
    arrays, feats = tiny_samples(cfg, n=4)
    state, stats = port_fit(cfg, jax_params(tiny_cfg), arrays, feats,
                            save_dir=str(tmp_path / "ckpt"),
                            vocabs={"word_dict": {"w": 1}})
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "epoch-1.ckpt", "epoch-1.ckpt.json", "epoch-2.ckpt",
        "epoch-2.ckpt.json", "metrics.jsonl"]
    sidecar = json.loads((tmp_path / "ckpt" / "epoch-2.ckpt.json")
                         .read_text())
    assert sidecar["word_dict"] == {"w": 1} and stats["steps"] == 2
    assert torch.load(tmp_path / "ckpt" / "epoch-2.ckpt",
                      weights_only=True)["step"] == state.step == 2


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "scripts/port_kernel_bounds.py",
                                    "scripts/flash_ab.py",
                                    "scripts/flash_variants.py",
                                    "scripts/qkv_bwd_ab.py",
                                    "scripts/mismatch_repeat.py",
                                    "scripts/mhsa_sep_ab.py",
                                    "scripts/mhsa_sep_variants.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts that drive the port on a GPU, where JAX need not be
    installed, import no JAX and nothing of the JAX package, as the port
    itself."""
    import ast
    import pathlib

    from tests.test_torch_package import FORBIDDEN

    path = pathlib.Path(__file__).parent.parent / script
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (script, name)
