"""The port's command line (cli.py, config.config_from_args) on the CPU:
the JAX package's flags parsed to the same config, the settings the port
does not run yet refused, the kernel switches wired, every mode run, and
``train_test`` against the JAX package's ``main`` on the same synthetic
dirs and initial weights, dropout off."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.config import config_from_args as jax_args
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu_torch import cli
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.config import (
    Config,
    check_supported,
    config_from_args,
)
from newsrecommendation_tpu_torch.ops import kernel_config
from newsrecommendation_tpu_torch.train import create_train_state

TINY = ["--num_words_title", "6", "--user_log_length", "8",
        "--word_embedding_dim", "16", "--news_dim", "16",
        "--num_attention_heads", "4", "--news_query_vector_dim", "8",
        "--user_query_vector_dim", "8", "--filter_num", "0",
        "--batch_size", "8", "--lr", "0.003", "--log_steps", "50",
        "--eval_batch_size", "16", "--max_candidates", "16"]


def dirs_args(synthetic_dirs, model_dir):
    train_dir, dev_dir = synthetic_dirs
    return ["--train_data_dir", train_dir, "--test_data_dir", dev_dir,
            "--model_dir", str(model_dir)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: at these widths the CPU ops are too small to
    share, and several test workers at once oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def switches():
    """The port's process-wide kernel switches, put back afterwards."""
    yield
    kernel_config.set_bwd_residuals("probs")
    kernel_config.set_fused_tail("auto")
    kernel_config.set_attention_layout("headloop")


def read_lines(model_dir, kind):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [x for x in map(json.loads, f) if x["kind"] == kind]


class TestConfig:
    def test_every_jax_flag_with_its_default(self):
        assert ([f.name for f in dataclasses.fields(Config)]
                and {f.name for f in dataclasses.fields(Config)}
                == {f.name for f in dataclasses.fields(JaxConfig)})
        assert dataclasses.asdict(config_from_args([])) == (
            dataclasses.asdict(jax_args([])))

    @pytest.mark.parametrize("argv", [
        ["--mode", "train_test", "--use_category", "True",
         "--freeze_embedding", "yes", "--user_log_mask", "0",
         "--lr", "3e-4", "--load_ckpt_name", "epoch-1.ckpt",
         "--max_candidates", "300", "--serve_max_delay_ms", "2.5",
         "--compute_dtype", "bfloat16", "--fused_tail", "on",
         "--data_parallel", "1", "--nGPU", "1", "--enable_gpu", "False"],
        ["--mode", "serve", "--serve_port", "0", "--serve_scorer", "gather",
         "--serve_cache_dtype", "bfloat16", "--embedding_backend", "hash",
         "--title_source", "doc_table", "--eval_steps_per_call", "3"]])
    def test_reference_command_lines_parse_as_jax(self, argv):
        assert dataclasses.asdict(config_from_args(argv)) == (
            dataclasses.asdict(jax_args(argv)))

    @pytest.mark.parametrize("argv", [["--model", "LSTUR"],
                                      ["--compute_dtype", "float16"],
                                      ["--eval_steps_per_call", "0"],
                                      ["--serve_scorer", "sparse"]])
    def test_invalid_values_rejected(self, argv):
        with pytest.raises(ValueError):
            config_from_args(argv)

    @pytest.mark.parametrize("argv, item", [
        (["--param_dtype", "bfloat16"], "float32"),
        (["--param_dtype", "float16"], "float32")])
    def test_what_the_port_cannot_run_raises(self, argv, item):
        with pytest.raises(ValueError, match=item):
            config_from_args(argv)

    @pytest.mark.parametrize("argv", [["--data_parallel", "2"],
                                      ["--nGPU", "4"],
                                      ["--table_shards", "2"]])
    def test_multi_gpu_flags_parse_as_jax(self, argv):
        """The mesh flags parse to the JAX package's config and pass
        check_supported on either device."""
        cfg = config_from_args(argv)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_args(argv))
        check_supported(cfg, "cpu")
        check_supported(cfg, "cuda")

    def test_naml_parses_as_jax_and_runs(self):
        """--model NAML (the fork's demo flags) parses to the JAX
        package's config and passes check_supported on either device."""
        argv = ["--model", "NAML", "--title_source", "doc_table",
                "--use_category", "True", "--use_subcategory", "True",
                "--freeze_embedding", "True", "--user_log_mask", "False",
                "--embedding_backend", "hash"]
        cfg = config_from_args(argv)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_args(argv))
        assert cfg.model == "NAML" and cfg.news_feature_width == 3
        for device in ("cpu", "cuda", torch.device("cuda", 0)):
            check_supported(cfg, device)

    def test_use_pallas_off_is_refused_on_the_card_only(self):
        cfg = config_from_args(["--use_pallas", "off"])
        check_supported(cfg, "cpu")
        check_supported(cfg, torch.device("cpu"))
        with pytest.raises(ValueError, match="no plain route on the card"):
            check_supported(cfg, "cuda")
        with pytest.raises(ValueError, match="no plain route"):
            check_supported(cfg, torch.device("cuda", 0))


def test_main_defaults_to_cuda(synthetic_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "read_embeddings"]
                 + dirs_args(synthetic_dirs, tmp_path))
    from newsrecommendation_tpu_torch.serve import Recommender
    from newsrecommendation_tpu_torch.server import run_server

    for run in (cli.run_train, cli.run_test, run_server):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recommender.from_checkpoint("x.ckpt", Config(), "data")


def test_switches_wired(synthetic_dirs, tmp_path, switches):
    """main sets the kernel switches from the flags before any model code
    (create_embeddings runs none)."""
    cli.main(["--mode", "create_embeddings", "--attention_layout", "blanes",
              "--fused_tail", "on", "--bwd_residuals", "recompute",
              "--embedding_backend", "hash", "--num_words_title", "4",
              "--word_embedding_dim", "8"]
             + dirs_args(synthetic_dirs, tmp_path / "m"), device="cpu")
    assert kernel_config.attention_layout() == "blanes"
    assert kernel_config.fused_tail_enabled()
    assert kernel_config.bwd_residuals() == "recompute"
    for d in synthetic_dirs:
        assert os.path.exists(os.path.join(d, "title_embeddings.hash.npy.gz"))


def bridged_init(jcfg):
    """cli.init_state drawing the JAX package's initial weights (its
    model.init from PRNGKey(seed), NAML's tables sized as cli.init_state
    is told), bridged: both mains start from the same params."""
    def init_state(cfg, model, table, device, num_category=0,
                   num_subcategory=0):
        jparams = jax_get_model(cfg.model).init(
            jax.random.PRNGKey(cfg.seed), jcfg, table, num_category,
            num_subcategory)
        return create_train_state(cfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), device=device))

    return init_state


@pytest.fixture
def jax_main(monkeypatch):
    """The JAX package's main, its process-wide settings put back."""
    from newsrecommendation_tpu.cli import main
    from newsrecommendation_tpu.ops.pallas import config as pallas_config

    monkeypatch.setenv("NEWSREC_COMPILE_CACHE", "")  # no cache in HOME
    prng = jax.config.jax_default_prng_impl
    yield main
    jax.config.update("jax_default_prng_impl", prng)
    pallas_config.set_pallas_mode("auto")
    pallas_config.set_fused_tail("auto")
    pallas_config.set_attention_layout("headloop")
    pallas_config.set_bwd_residuals("probs")


def test_train_test_matches_jax_main(synthetic_dirs, tmp_path, monkeypatch,
                                     jax_main, switches):
    """train_test, dropout off, two epochs: the port's eval line (AUC, MRR,
    nDCG@5/10 in percent, four decimals) within 1e-4 of the JAX
    package's (one unit of its last decimal); the same checkpoints and
    train lines; then --mode test from the newest checkpoint gives the
    eval line of that checkpoint."""
    argv = (["--mode", "train_test", "--epochs", "2", "--deterministic",
             "True", "--data_parallel", "1", "--save_steps", "20"] + TINY)
    jax_main(argv + dirs_args(synthetic_dirs, tmp_path / "jax"))
    jcfg = jax_args(argv + dirs_args(synthetic_dirs, tmp_path / "jax"))
    monkeypatch.setattr(cli, "init_state", bridged_init(jcfg))
    cli.main(argv + dirs_args(synthetic_dirs, tmp_path / "port"),
             device="cpu")

    def ckpts(d):
        return sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))

    assert ckpts(tmp_path / "port") == ckpts(tmp_path / "jax")
    assert "epoch-2.ckpt" in ckpts(tmp_path / "port")
    (want,), (got,) = (read_lines(tmp_path / s, "eval")
                       for s in ("jax", "port"))
    assert got["samples"] == want["samples"] == 60
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        # 1e-4 and the float error of subtracting two 4-decimal numbers
        assert abs(got[key] - want[key]) <= 1e-4 + 1e-9, key
    assert got["doc_sim"] == pytest.approx(want["doc_sim"], abs=1e-3)
    jt, pt = (read_lines(tmp_path / s, "train") for s in ("jax", "port"))
    assert [(x["epoch"], x["step"]) for x in pt] == [
        (x["epoch"], x["step"]) for x in jt]
    np.testing.assert_allclose([x["loss"] for x in pt],
                               [x["loss"] for x in jt], atol=2e-4)

    cli.main(["--mode", "test", "--load_ckpt_name", "latest"] + TINY
             + dirs_args(synthetic_dirs, tmp_path / "port"), device="cpu")
    first, again = read_lines(tmp_path / "port", "eval")
    assert again["ckpt"] == "latest" and first["ckpt"] is None
    # newest by (epoch, step): the mid-epoch save after the last step
    assert cli.latest_checkpoint(str(tmp_path / "port")).endswith(
        "epoch-2-20.ckpt")


def test_naml_train_test_matches_jax_main(synthetic_dirs, tmp_path,
                                         monkeypatch, jax_main, switches):
    """NAML through the command line, the fork's demo flags at tiny
    widths (the hash per-title table made by --mode create_embeddings,
    both category views, a frozen table, the pad-doc user path), dropout
    off, two epochs: the port's eval and train lines against the JAX
    package's main, as for NRMS; then --mode test from the newest
    checkpoint, whose tables take the sidecar's vocabulary sizes."""
    cli.main(["--mode", "create_embeddings", "--embedding_backend", "hash"]
             + TINY + dirs_args(synthetic_dirs, tmp_path / "emb"),
             device="cpu")
    argv = (["--mode", "train_test", "--epochs", "2", "--deterministic",
             "True", "--data_parallel", "1", "--model", "NAML",
             "--title_source", "doc_table", "--embedding_backend", "hash",
             "--use_category", "True", "--use_subcategory", "True",
             "--category_emb_dim", "8", "--freeze_embedding", "True",
             "--user_log_mask", "False"] + TINY)
    jax_main(argv + dirs_args(synthetic_dirs, tmp_path / "jax"))
    jcfg = jax_args(argv + dirs_args(synthetic_dirs, tmp_path / "jax"))
    monkeypatch.setattr(cli, "init_state", bridged_init(jcfg))
    cli.main(argv + dirs_args(synthetic_dirs, tmp_path / "port"),
             device="cpu")
    (want,), (got,) = (read_lines(tmp_path / s, "eval")
                       for s in ("jax", "port"))
    assert got["samples"] == want["samples"] == 60
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert abs(got[key] - want[key]) <= 1e-4 + 1e-9, key
    assert got["doc_sim"] == pytest.approx(want["doc_sim"], abs=1e-3)
    jt, pt = (read_lines(tmp_path / s, "train") for s in ("jax", "port"))
    assert [(x["epoch"], x["step"]) for x in pt] == [
        (x["epoch"], x["step"]) for x in jt] and pt
    np.testing.assert_allclose([x["loss"] for x in pt],
                               [x["loss"] for x in jt], atol=2e-4)
    blob = torch.load(tmp_path / "port" / "epoch-2.ckpt", weights_only=True)
    with open(tmp_path / "port" / "epoch-2.ckpt.json") as f:
        sidecar = json.load(f)
    ne = blob["params"]["news_encoder"]
    assert blob["frozen_table_excluded"] is True
    assert ne["category_emb"].shape[0] == len(sidecar["category_dict"]) + 1
    assert ne["subcategory_emb"].shape[0] == (
        len(sidecar["subcategory_dict"]) + 1)
    monkeypatch.undo()
    cli.main(["--mode", "test", "--load_ckpt_name", "epoch-2.ckpt"]
             + argv[2:] + dirs_args(synthetic_dirs, tmp_path / "port"),
             device="cpu")
    again = read_lines(tmp_path / "port", "eval")[-1]
    for key in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert again[key] == got[key], key


def test_train_resume_and_embeddings_modes(synthetic_dirs, tmp_path,
                                           switches):
    """train, then train again from the newest checkpoint at start_epoch
    1 (the step carries on), test, create_embeddings and read_embeddings
    with a doc_table run over the hash table, and GloVe vectors."""
    model_dir = tmp_path / "m"
    base = TINY + dirs_args(synthetic_dirs, model_dir)
    cli.main(["--mode", "train", "--epochs", "1"] + base, device="cpu")
    assert sorted(os.listdir(model_dir)) == [
        "epoch-1.ckpt", "epoch-1.ckpt.json", "metrics.jsonl"]
    first = torch.load(model_dir / "epoch-1.ckpt", weights_only=True)
    cli.main(["--mode", "train", "--epochs", "2", "--start_epoch", "1",
              "--load_ckpt_name", "latest", "--prepare", "False"] + base,
             device="cpu")
    second = torch.load(model_dir / "epoch-2.ckpt", weights_only=True)
    assert second["step"] == 2 * first["step"]
    assert not (model_dir / "epoch-2-0.ckpt").exists()

    cli.main(["--mode", "create_embeddings", "--embedding_backend", "hash"]
             + base, device="cpu")
    cli.main(["--mode", "read_embeddings", "--embedding_backend", "hash"]
             + base, device="cpu")
    doc = ["--title_source", "doc_table", "--freeze_embedding", "True",
           "--embedding_backend", "hash", "--epochs", "1"]
    cli.main(["--mode", "train_test"] + doc + TINY
             + dirs_args(synthetic_dirs, tmp_path / "doc"), device="cpu")
    blob = torch.load(tmp_path / "doc" / "epoch-1.ckpt", weights_only=True)
    assert blob["frozen_table_excluded"] is True
    (line,) = read_lines(tmp_path / "doc", "eval")
    assert 0 < line["auc"] < 100 and line["samples"] == 60

    glove = tmp_path / "glove.txt"
    glove.write_text("".join(f"w{i} " + " ".join(["0.5"] * 16) + "\n"
                             for i in range(40)))
    cli.main(["--mode", "train", "--glove_embedding_path", str(glove),
              "--epochs", "1"] + TINY
             + dirs_args(synthetic_dirs, tmp_path / "glove"), device="cpu")
    assert (tmp_path / "glove" / "epoch-1.ckpt").exists()


def test_serve_mode_through_main(synthetic_dirs, tmp_path, monkeypatch,
                                 switches):
    """--mode serve: main hands the config and device to run_server, which
    serves the newest checkpoint of a train run (run here without
    blocking, so the test can query and stop it)."""
    import http.client

    from newsrecommendation_tpu_torch import server

    base = TINY + dirs_args(synthetic_dirs, tmp_path / "m")
    cli.main(["--mode", "train", "--epochs", "1"] + base, device="cpu")
    started = []
    real = server.run_server

    def run_server(cfg, **kw):
        started.append(real(cfg, block=False, **kw))

    monkeypatch.setattr(server, "run_server", run_server)
    cli.main(["--mode", "serve", "--serve_port", "0",
              "--load_ckpt_name", "latest"] + base, device="cpu")
    (srv,) = started
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=60)
        conn.request("POST", "/score", body=json.dumps(
            {"history": ["N1", "N2"], "candidates": ["N3", "N4", "N5"]}))
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
        assert resp.status == 200 and len(body["scores"]) == 3
        assert srv.rec.device.type == "cpu" and srv.rebuild is not None
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()


def test_python_dash_m_entry_point():
    """``python -m newsrecommendation_tpu_torch.cli`` parses the JAX flags
    and refuses what the port does not run, before any device work."""
    proc = subprocess.run(
        [sys.executable, "-m", "newsrecommendation_tpu_torch.cli",
         "--param_dtype", "bfloat16"], capture_output=True, text=True,
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0 and "keeps its params in float32" in (
        proc.stderr)


class TestTitleStore:
    """The GloVe reader and the per-title table store
    (data/mind.py:load_glove_matrix, data/embeddings.py) against the JAX
    package's."""

    def test_glove_matches_jax(self, tmp_path):
        from newsrecommendation_tpu.data.mind import (
            load_glove_matrix as jax_glove,
        )
        from newsrecommendation_tpu_torch.data.mind import load_glove_matrix

        glove = tmp_path / "glove.txt"
        glove.write_text("apple 1.0 2.0 3.0\n\nbanana -0.5 0.0 0.5\n"
                         "unused 9.0 9.0 9.0\ncaf\xe9 4 5 6\n",
                         encoding="utf-8")
        word_dict = {"apple": 1, "cherry": 2, "banana": 3, "caf\xe9": 4}
        matrix, have = load_glove_matrix(str(glove), word_dict, dim=3)
        jmatrix, jhave = jax_glove(str(glove), word_dict, dim=3)
        np.testing.assert_array_equal(matrix, jmatrix)
        assert have == jhave == ["apple", "banana", "caf\xe9"]
        np.testing.assert_array_equal(matrix[[0, 2]], 0.0)
        np.testing.assert_array_equal(matrix[1], [1.0, 2.0, 3.0])
        matrix, have = load_glove_matrix(str(tmp_path / "none.txt"),
                                         {"a": 1}, dim=4)
        assert matrix.shape == (2, 4) and not have and not matrix.any()

    def test_hash_table_bit_equal_to_jax(self, synthetic_dirs, tmp_path):
        import shutil

        from newsrecommendation_tpu.data.embeddings import (
            create_news_embeddings as jax_create,
        )
        from newsrecommendation_tpu_torch.data.embeddings import (
            create_news_embeddings,
            read_news_embeddings,
        )

        for side in ("port", "jax"):
            (tmp_path / side).mkdir()
            shutil.copy(os.path.join(synthetic_dirs[0], "news.tsv"),
                        tmp_path / side / "news.tsv")
        table = create_news_embeddings(str(tmp_path / "port"), 6, dim=16,
                                       backend="hash")
        jtable = jax_create(str(tmp_path / "jax"), 6, dim=16, backend="hash")
        assert table.dtype == jtable.dtype == np.float32
        assert table.shape == (61, 6 * 16) and not table[0].any()
        np.testing.assert_array_equal(table, jtable)
        for name in ("embeddings_doc_ids.pkl", "doc_id_dict.pkl"):
            assert (tmp_path / "port" / name).read_bytes() == (
                tmp_path / "jax" / name).read_bytes()
        np.testing.assert_array_equal(
            read_news_embeddings(str(tmp_path / "jax"), backend="bert"),
            jtable)  # falls back across backends' files
        with pytest.raises(FileNotFoundError, match="create_embeddings"):
            read_news_embeddings(str(tmp_path))

    def test_bpemb_raises_as_jax(self):
        from newsrecommendation_tpu.data.embeddings import (
            make_embedder as jax_make,
        )
        from newsrecommendation_tpu_torch.data.embeddings import make_embedder

        with pytest.raises(ImportError) as jerr:
            jax_make("bpemb", 8)
        with pytest.raises(ImportError) as err:
            make_embedder("bpemb", 8)
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError, match="unknown backend"):
            make_embedder("glove", 8)

    def test_tiny_bert_table_matches_jax(self, tmp_path, monkeypatch):
        pytest.importorskip("transformers")
        from newsrecommendation_tpu.data.embeddings import (
            create_news_embeddings as jax_create,
        )
        from newsrecommendation_tpu_torch.data.embeddings import (
            create_news_embeddings,
        )
        from tests.test_bert_backend import HIDDEN, tiny_bert_dir

        class Factory:  # tmp_path_factory's mktemp, under tmp_path
            def mktemp(self, name):
                (tmp_path / name).mkdir()
                return tmp_path / name

        # the tiny BERT that tests/test_bert_backend.py's fixture builds
        bert = tiny_bert_dir.__wrapped__(Factory())
        monkeypatch.setenv("NEWSREC_BERT_MODEL", bert)
        lines = ["N1\tsports\tfootball\tthe team wins big game\t\t\t\t",
                 "N2\tnews\tpets\ta story about cats\t\t\t\t",
                 "N3\tnews\tempty\t\t\t\t\t"]
        for side in ("port", "jax"):
            (tmp_path / side).mkdir()
            (tmp_path / side / "news.tsv").write_text("\n".join(lines) + "\n")
        table = create_news_embeddings(str(tmp_path / "port"), 6,
                                       dim=HIDDEN, backend="bert")
        jtable = jax_create(str(tmp_path / "jax"), 6, dim=HIDDEN,
                            backend="bert")
        assert table.shape == (4, 6 * HIDDEN) and table[1].any()
        assert not table[3].any()  # an empty title: zero rows
        np.testing.assert_array_equal(table, jtable)
