"""The port's training input against the JAX package's: negative sampling,
prepared shards (byte for byte), the parsed TrainSamples, per-epoch
candidate arrays and batches; and the background staging of batches
(stage_ahead) with the cases of tests/test_prefetch.py."""

import random
import shutil
import threading
import time

import numpy as np
import pytest

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.data import loader as jax_loader
from newsrecommendation_tpu.data import prepare as jax_prepare
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data import build_news_features, read_news
from newsrecommendation_tpu_torch.data import prepare
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
from newsrecommendation_tpu_torch.train.prefetch import stage_ahead

NPRATIO = 4


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    """The same synthetic corpus in two directories, one per package."""
    root = tmp_path_factory.mktemp("train_data")
    ours, theirs = root / "port", root / "jax"
    generate_corpus(str(ours), num_news=80, num_users=20,
                    num_impressions=150, max_history=60, seed=3)
    shutil.copytree(ours, theirs)
    n = prepare.prepare_training_data(str(ours), 2, NPRATIO, seed=7)
    m = jax_prepare.prepare_training_data(str(theirs), 2, NPRATIO, seed=7)
    assert n == m > 150
    return ours, theirs


@pytest.mark.parametrize("k", [2, 4, 9])
def test_sample_negatives_matches_jax(k):
    pool = [f"N{i}" for i in range(5)]
    a, b = random.Random(11), random.Random(11)
    for _ in range(20):  # the streams stay in step over many draws
        assert prepare.sample_negatives(pool, k, a) == \
            jax_prepare.sample_negatives(pool, k, b)


def test_prepared_shards_identical_to_jax(corpus_dirs):
    ours, theirs = corpus_dirs
    for shard in range(2):
        name = f"behaviors_np{NPRATIO}_{shard}.tsv"
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()


def _samples(corpus_dirs, shard=0):
    ours, _ = corpus_dirs
    cfg = Config(num_words_title=8, user_log_length=50, npratio=NPRATIO)
    corpus = read_news(str(ours / "news.tsv"), cfg)
    path = str(ours / f"behaviors_np{NPRATIO}_{shard}.tsv")
    port = TrainSamples.from_file(path, corpus.news_index, cfg)
    jcfg = JaxConfig(num_words_title=8, user_log_length=50, npratio=NPRATIO)
    ref = jax_loader.TrainSamples.from_file(path, corpus.news_index, jcfg,
                                            use_native=False)
    return port, ref, build_news_features(corpus, cfg)


def test_train_samples_match_jax(corpus_dirs):
    port, ref, _ = _samples(corpus_dirs)
    assert port.num_samples == ref.num_samples > 50
    assert port.npratio == NPRATIO
    for name in ("history", "history_mask", "pos", "neg"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    # histories longer than L keep the last L; shorter ones are front-padded
    assert (port.history_mask.sum(1) == 50).any()
    assert (port.history_mask[:, 0] == 0).any()


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_arrays_match_jax(corpus_dirs, shuffle):
    port, ref, _ = _samples(corpus_dirs)
    for epoch in (0, 3):
        got = port.epoch_arrays(epoch, seed=5, shuffle=shuffle)
        want = ref.epoch_arrays(epoch, seed=5, shuffle=shuffle)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    hist, mask, cand, label = got
    if not shuffle:  # the positive sits at the label's slot
        assert (cand[np.arange(len(label)), label] == port.pos).all()


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("pad_final", [False, True])
def test_batches_match_jax(corpus_dirs, index, pad_final):
    port, ref, feats = _samples(corpus_dirs, shard=1)
    bs = 16
    assert port.num_samples % bs  # a ragged final batch
    if index:
        got = list(port.iter_index_batches(bs, 1, 2, pad_final=pad_final))
        want = list(ref.iter_index_batches(bs, 1, 2, pad_final=pad_final))
    else:
        got = list(port.iter_batches(feats, bs, 1, 2, pad_final=pad_final))
        want = list(ref.iter_batches(feats, bs, 1, 2, pad_final=pad_final))
    assert len(got) == len(want) == port.num_samples // bs + pad_final
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].shape[0] == bs and a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    if pad_final:
        assert 0 < got[-1]["weight"].sum() < bs


def test_stage_ahead_keeps_order():
    out = list(stage_ahead(range(100), lambda x: x * x, depth=3))
    assert out == [x * x for x in range(100)]


def test_stage_ahead_depth_zero_is_inline():
    main = threading.current_thread().name
    seen = []
    list(stage_ahead(range(5), lambda x: seen.append(
        threading.current_thread().name), depth=0))
    assert set(seen) == {main}


def test_stage_ahead_runs_on_one_worker_thread():
    main = threading.current_thread().name
    names = list(stage_ahead(range(5),
                             lambda x: threading.current_thread().name,
                             depth=2))
    assert all(n != main for n in names) and len(set(names)) == 1


def test_stage_ahead_relays_stage_errors():
    def bad(x):
        if x == 3:
            raise ValueError("boom at 3")
        return x

    it = stage_ahead(range(10), bad, depth=2)
    assert [next(it), next(it), next(it)] == [0, 1, 2]
    with pytest.raises(ValueError, match="boom at 3"):
        list(it)


def test_stage_ahead_relays_iterator_errors():
    def items():
        yield 1
        raise RuntimeError("source died")

    it = stage_ahead(items(), lambda x: x, depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


def test_stage_ahead_early_close_stops_the_worker():
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield i

    it = stage_ahead(items(), lambda x: x, depth=2)
    assert next(it) == 0
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 6.0
    n_after_close = len(produced)
    time.sleep(0.3)
    assert len(produced) <= n_after_close + 2  # the worker stopped pulling
