"""The port's native behaviors parser (data/native_loader.py on
csrc/mindio.cpp) against the port's pure-Python parser and both of the JAX
package's parsers: the same arrays, element for element and dtype for
dtype; malformed lines, CRLF files and empty files as the Python parser
reads them; and the build: keyed by the source, atomic, safe for
processes that build at once, and a Python fallback, on record, without
g++."""

import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from newsrecommendation_tpu.data import loader as jax_loader
from newsrecommendation_tpu.data import native_loader as jax_native
from newsrecommendation_tpu_torch.data import native_loader
from newsrecommendation_tpu_torch.data import (
    EvalSamples,
    TrainSamples,
    prepare_testing_data,
    prepare_training_data,
    read_news,
)
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data.loader import CandidateTruncationError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BUILD = os.path.join(REPO, "newsrecommendation_tpu_torch", "_build")
TRAIN_KEYS = ("history", "history_mask", "pos", "neg")
EVAL_KEYS = ("history", "history_mask", "candidates", "labels",
             "candidate_mask")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the parser")


def port_cfg(jcfg, **kw):
    return Config(**{"user_log_length": jcfg.user_log_length,
                     "npratio": jcfg.npratio,
                     "num_words_title": jcfg.num_words_title, **kw})


def assert_same(got, want, keys):
    for k in keys:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture
def corpora(synthetic_dirs, tiny_cfg):
    train_dir, dev_dir = synthetic_dirs
    prepare_testing_data(dev_dir, 1)
    cfg = port_cfg(tiny_cfg)
    return dict(train_dir=train_dir, dev_dir=dev_dir,
                train=read_news(os.path.join(train_dir, "news.tsv"), cfg),
                dev=read_news(os.path.join(dev_dir, "news.tsv"), cfg))


@pytest.mark.parametrize("L,K", [(4, 1), (10, 4), (50, 4)])
def test_train_arrays_equal_every_parser(corpora, tiny_cfg, L, K):
    prepare_training_data(corpora["train_dir"], 1, K, 0)
    path = os.path.join(corpora["train_dir"], f"behaviors_np{K}_0.tsv")
    index = corpora["train"].news_index
    jcfg = tiny_cfg.replace(user_log_length=L, npratio=K)
    cfg = port_cfg(jcfg)
    native = TrainSamples.from_file(path, index, cfg)
    assert native_loader.last_parser() == "native"
    python = TrainSamples.from_file(path, index, cfg, use_native=False)
    assert native_loader.last_parser() == "python"
    assert native.num_samples > 100 and native.neg.shape[1] == K
    assert (native.history_mask[:, 0] == 0).any()  # front-padded rows
    if L < 30:  # the corpus's longest history: rows cut to their last L
        assert (native.history_mask.sum(1) == L).any()
    jax_py = jax_loader.TrainSamples.from_file(path, index, jcfg,
                                               use_native=False)
    h, m, p, n = jax_native.parse_train_file(path, index, L, K)
    jax_nat = jax_loader.TrainSamples(history=h, history_mask=m, pos=p,
                                      neg=n)
    for want in (python, jax_py, jax_nat):
        assert_same(native, want, TRAIN_KEYS)


@pytest.mark.parametrize("width", ["16", "widest"])
def test_eval_arrays_equal_every_parser(corpora, tiny_cfg, width):
    path = os.path.join(corpora["dev_dir"], "behaviors_0.tsv")
    index = corpora["dev"].news_index
    cfg = port_cfg(tiny_cfg)
    widest = EvalSamples.from_file(path, index, cfg).candidates.shape[1]
    c = 16 if width == "16" else widest
    assert c >= widest  # no impression is truncated
    native = EvalSamples.from_file(path, index, cfg, max_candidates=c)
    assert native_loader.last_parser() == "native"
    python = EvalSamples.from_file(path, index, cfg, max_candidates=c,
                                   use_native=False)
    jax_py = jax_loader.EvalSamples.from_file(path, index, tiny_cfg,
                                              max_candidates=c,
                                              use_native=False)
    jax_nat = jax_loader.EvalSamples.from_file(path, index, tiny_cfg,
                                               max_candidates=c,
                                               use_native=True)
    assert native.candidates.shape == (60, c)
    for want in (python, jax_py, jax_nat):
        assert_same(native, want, EVAL_KEYS)


def both_train(path, index, cfg):
    native = TrainSamples.from_file(path, index, cfg)
    assert native_loader.last_parser() == "native"
    python = TrainSamples.from_file(path, index, cfg, use_native=False)
    assert_same(native, python, TRAIN_KEYS)
    return native


def both_eval(path, index, cfg, width):
    native = EvalSamples.from_file(path, index, cfg, max_candidates=width)
    assert native_loader.last_parser() == "native"
    python = EvalSamples.from_file(path, index, cfg, max_candidates=width,
                                   use_native=False)
    assert_same(native, python, EVAL_KEYS)
    return native


def test_unknown_ids_map_to_zero(corpora, tiny_cfg, tmp_path):
    index = corpora["train"].news_index
    p = tmp_path / "b.tsv"
    p.write_text("1\tU1\ttime\tUNKNOWN_DOC N1\tN1\tN2 N3 UNKNOWN2 N4\n")
    s = both_train(str(p), index, port_cfg(tiny_cfg, npratio=4))
    assert s.history[0, -1] == index["N1"] and s.history[0, -2] == 0
    assert s.history_mask[0, -2] == 1.0  # an unknown click keeps its slot
    assert s.neg[0].tolist() == [index["N2"], index["N3"], 0, index["N4"]]
    q = tmp_path / "e.tsv"
    q.write_text("1\tU1\ttime\tN1\tGONE-1 N2-0\n")
    e = both_eval(str(q), index, port_cfg(tiny_cfg), 4)
    assert e.candidates[0].tolist() == [0, index["N2"], 0, 0]
    assert e.labels[0].tolist() == [1, 0, 0, 0]


def test_empty_history_and_double_spaces(corpora, tiny_cfg, tmp_path):
    index = corpora["train"].news_index
    p = tmp_path / "b.tsv"
    p.write_text("1\tU1\ttime\t\tN1\tN2 N3 N4\n"
                 "2\tU2\ttime\t  N5   N6 \t N1 \tN2  N3   N4\n")
    s = both_train(str(p), index, port_cfg(tiny_cfg))
    assert s.history_mask[0].sum() == 0 and s.history[0].sum() == 0
    assert s.history[1, -2:].tolist() == [index["N5"], index["N6"]]
    assert s.history_mask[1].sum() == 2
    assert s.pos.tolist() == [index["N1"]] * 2
    assert s.neg[1].tolist() == [index["N2"], index["N3"], index["N4"]]
    q = tmp_path / "e.tsv"
    q.write_text("1\tU1\ttime\t\tN1-1  N2-0\n")
    e = both_eval(str(q), index, port_cfg(tiny_cfg), 3)
    assert e.candidate_mask[0].tolist() == [1, 1, 0]


def test_no_trailing_newline(corpora, tiny_cfg, tmp_path):
    index = corpora["train"].news_index
    p = tmp_path / "b.tsv"
    p.write_text("1\tU1\ttime\tN1\tN2\tN3 N4 N5\n"
                 "2\tU2\ttime\tN6\tN7\tN8 N9 N10")
    s = both_train(str(p), index, port_cfg(tiny_cfg))
    assert s.num_samples == 2 and s.neg[1, -1] == index["N10"]
    q = tmp_path / "e.tsv"
    q.write_text("1\tU1\ttime\tN1\tN2-1 N3-0")
    e = both_eval(str(q), index, port_cfg(tiny_cfg), 2)
    assert e.labels[0].tolist() == [1, 0]


def test_crlf_equals_the_python_parser(corpora, tiny_cfg, tmp_path):
    """A CRLF shard gives the LF shard's arrays. The JAX package's native
    parser looks up "N5\\r" and maps the last negative to 0; the port does
    not copy that."""
    index = corpora["train"].news_index
    lines = ["1\tU1\ttime\tN1 N2\tN3\tN4 N5", "2\tU2\ttime\tN6\tN7\tN8 N9"]
    lf, crlf = tmp_path / "lf.tsv", tmp_path / "crlf.tsv"
    lf.write_bytes("\n".join(lines).encode() + b"\n")
    crlf.write_bytes("\r\n".join(lines).encode() + b"\r\n")
    cfg = port_cfg(tiny_cfg, npratio=2)
    s = both_train(str(crlf), index, cfg)
    assert_same(s, both_train(str(lf), index, cfg), TRAIN_KEYS)
    assert s.neg[:, -1].tolist() == [index["N5"], index["N9"]]
    _, _, _, jax_neg = jax_native.parse_train_file(str(crlf), index,
                                                   cfg.user_log_length, 2)
    assert jax_neg[:, -1].tolist() == [0, 0]
    ev = ["1\tU1\ttime\tN1\tN2-1 N3-0", "2\tU2\ttime\tN4\tN5-0 N6-1"]
    e_lf, e_crlf = tmp_path / "elf.tsv", tmp_path / "ecrlf.tsv"
    e_lf.write_bytes("\n".join(ev).encode() + b"\n")
    e_crlf.write_bytes("\r\n".join(ev).encode() + b"\r\n")
    assert_same(both_eval(str(e_crlf), index, cfg, 2),
                both_eval(str(e_lf), index, cfg, 2), EVAL_KEYS)


def test_empty_file_gives_zero_rows(corpora, tiny_cfg, tmp_path):
    index = corpora["train"].news_index
    p = tmp_path / "empty.tsv"
    p.write_text("")
    cfg = port_cfg(tiny_cfg)
    s = both_train(str(p), index, cfg)
    assert s.history.shape == s.history_mask.shape == (0, cfg.user_log_length)
    assert s.pos.shape == (0,) and s.neg.shape == (0, cfg.npratio)
    e = both_eval(str(p), index, cfg, 7)
    assert e.history.shape == (0, cfg.user_log_length)
    assert e.candidates.shape == e.labels.shape == (0, 7)
    assert EvalSamples.from_file(str(p), index, cfg).candidates.shape == (0,
                                                                          0)


@pytest.mark.parametrize("kind,text", [
    ("train", "1\tU1\ttime\tN1\tN2\tN3 N4 N5\n1\tU1\ttime\tN1\tN2\n"),
    ("train", "1\tU1\ttime\tN1\tN2\tN3 N4 N5\n\n1\tU1\ttime\tN1\tN2\tN3\n"),
    ("train", "1\tU1\ttime\tN1\tN2\tN3 N4 N5\n1\tU1\ttime\tN1\t \tN3\n"),
    ("eval", "1\tU1\ttime\tN1\tN2-1\n1\tU1\ttime\tN1\n"),
    ("eval", "1\tU1\ttime\tN1\tN2-1\n1\tU1\ttime\tN1\tN2-1 N3\n"),
    ("eval", "1\tU1\ttime\tN1\tN2-1\r\n\r\n"),
], ids=["train-short", "train-empty-line", "train-no-pos", "eval-short",
        "eval-no-label", "eval-crlf-empty-line"])
def test_malformed_line_raises_naming_it(corpora, tiny_cfg, tmp_path, kind,
                                         text):
    index = corpora["train"].news_index
    p = tmp_path / "bad.tsv"
    p.write_bytes(text.encode())
    cfg = port_cfg(tiny_cfg)
    for use_native in (True, False):
        with pytest.raises(ValueError, match=f"{p}:2: malformed") as err:
            if kind == "train":
                TrainSamples.from_file(str(p), index, cfg,
                                       use_native=use_native)
            else:
                EvalSamples.from_file(str(p), index, cfg, max_candidates=4,
                                      use_native=use_native)
        assert isinstance(err.value, native_loader.ParseError)


@pytest.mark.parametrize("use_native", [True, False])
def test_candidate_truncation_message_is_jax(corpora, tiny_cfg, tmp_path,
                                             use_native):
    index = corpora["dev"].news_index
    p = tmp_path / "wide.tsv"
    wide = " ".join(f"N{(i % 9) + 1}-{1 if i == 0 else 0}" for i in range(400))
    p.write_text(f"1\tU1\ttime\tN1 N2\t{wide}\n"
                 "2\tU2\ttime\tN1\tN1-1 N2-0\n")
    cfg = port_cfg(tiny_cfg)
    with pytest.raises(jax_loader.CandidateTruncationError) as jerr:
        jax_loader.EvalSamples.from_file(str(p), index, tiny_cfg,
                                         max_candidates=384,
                                         use_native=use_native)
    native_loader.reset_parser_counts()
    with pytest.raises(CandidateTruncationError) as err:
        EvalSamples.from_file(str(p), index, cfg, max_candidates=384,
                              use_native=use_native)
    assert str(err.value) == str(jerr.value)
    assert "widest observed: 400" in str(err.value)
    es = EvalSamples.from_file(str(p), index, cfg, max_candidates=384,
                               use_native=use_native, allow_truncation=True)
    parser = "native" if use_native else "python"
    assert native_loader.parser_counts()[parser] == 1
    assert native_loader.last_parser() == parser
    assert es.candidates.shape == (2, 384)
    assert es.candidate_mask.sum(1).tolist() == [384, 2]


def test_build_is_keyed_by_the_source(tmp_path):
    src = tmp_path / "mindio.cpp"
    shutil.copy(native_loader._SRC, src)
    root = tmp_path / "build"
    first = native_loader.build(str(src), str(root))
    assert first == native_loader.so_path(str(src), str(root))
    assert os.listdir(os.path.dirname(first)) == ["libmindio.so"]
    assert native_loader.build(str(src), str(root)) == first  # reused
    with open(src, "a") as f:
        f.write("// changed\n")
    second = native_loader.build(str(src), str(root))
    assert second != first and os.path.exists(second)
    assert sorted(os.listdir(root)) == sorted(
        os.path.basename(os.path.dirname(x)) for x in (first, second))
    assert not [f for _, _, fs in os.walk(root) for f in fs
                if f.endswith(".tmp")]


def test_builds_into_the_port_package_only():
    """The library lives under the port's _build, never the JAX package's
    native/_build."""
    assert native_loader.available()
    so = os.path.realpath(native_loader._load()._name)
    assert os.path.commonpath([so, PORT_BUILD]) == PORT_BUILD
    assert so == os.path.realpath(native_loader.so_path())
    assert native_loader._SRC == os.path.join(
        REPO, "newsrecommendation_tpu_torch", "csrc", "mindio.cpp")
    jax_build = os.path.join(REPO, "native", "_build")
    assert os.path.commonpath([so, jax_build]) != jax_build


_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data import TrainSamples, native_loader
native_loader._BUILD_ROOT = {root!r}
index = {{f"N{{i}}": i for i in range(1, 61)}}
cfg = Config(user_log_length=10, npratio=3)
a = TrainSamples.from_file({path!r}, index, cfg)
b = TrainSamples.from_file({path!r}, index, cfg, use_native=False)
assert native_loader.parser_counts() == {{"native": 1, "python": 1}}
for k in ("history", "history_mask", "pos", "neg"):
    np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
print("ok", a.num_samples, native_loader.build_seconds is not None)
"""


def test_processes_building_at_once_both_parse(synthetic_dirs, tiny_cfg,
                                               tmp_path):
    train_dir, _ = synthetic_dirs
    prepare_training_data(train_dir, 1, 3, 0)
    root = tmp_path / "fresh"
    code = _CHILD.format(repo=REPO, root=str(root), path=os.path.join(
        train_dir, "behaviors_np3_0.tsv"))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "ok" and int(out.split()[1]) > 100
    files = [f for _, _, fs in os.walk(root) for f in fs]
    assert files == ["libmindio.so"]


def test_without_gxx_the_python_parser_runs_on_record(
        corpora, tiny_cfg, tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setattr(native_loader, "_BUILD_ROOT", str(tmp_path / "b"))
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", False)
    path = os.path.join(corpora["dev_dir"], "behaviors_0.tsv")
    cfg = port_cfg(tiny_cfg)
    native_loader.reset_parser_counts()
    with caplog.at_level(logging.INFO):
        es = EvalSamples.from_file(path, corpora["dev"].news_index, cfg,
                                   max_candidates=16)
    assert not native_loader.available()
    assert native_loader.last_parser() == "python"
    assert native_loader.parser_counts() == {"native": 0, "python": 1}
    assert "g++ not found" in caplog.text
    assert f"{path}: 60 rows by the python parser" in caplog.text
    assert es.candidates.shape == (60, 16)
    assert not os.path.exists(tmp_path / "b")


def test_arrays_free_their_buffer_after_the_last_view(tmp_path):
    """The parsed arrays view the library's buffers without a copy; each
    buffer is freed once, when no view of it is left."""
    import ctypes
    import gc

    lib = native_loader._load()
    freed = []

    class Spy:
        def mindio_free(self, addr):
            freed.append(addr)
            lib.mindio_free(addr)

    p = tmp_path / "b.tsv"
    p.write_text("1\tU1\ttime\tN1 N2\tN3\tN4 N5\n")
    handle = native_loader._make_index(lib, {"N1": 1, "N2": 2, "N4": 4})
    try:
        res = native_loader._TrainResult()
        assert lib.mindio_parse_train(handle, os.fsencode(p), 3, 2,
                                      ctypes.byref(res)) == 1
    finally:
        lib.mindio_index_free(handle)
    hist = native_loader._take(Spy(), res.history, (1, 3), np.int32)
    neg = native_loader._take(Spy(), res.neg, (1, 2), np.int32)
    assert hist.tolist() == [[0, 1, 2]] and neg.tolist() == [[4, 0]]
    assert hist.flags.writeable
    view = hist[:, 1:]
    del hist
    gc.collect()
    assert freed == []
    del view, neg
    gc.collect()
    assert len(freed) == 2 and len(set(freed)) == 2
    for ptr in (res.history_mask, res.pos):
        lib.mindio_free(ctypes.cast(ptr, ctypes.c_void_p))
