"""The port's data parallelism and row-sharded tables in live gloo groups
on the CPU, against the JAX package's shard_map step and the port's own
single-process step.

One module-scoped fixture writes the inputs (weights from the JAX
package's init, bridged; batches made from seeds with numpy) and starts
every worker at once: a group of 2 ranks and one of 4
(tests/torch_mp_worker.py, gloo through a file under the test's temp
dir, one thread each, a 60 s timeout on every collective), and cli.main's
own launch of 2 ranks. The JAX side runs here, on the conftest's eight
CPU devices, with make_mesh(..., devices=jax.devices()[:dp * ts]).

Covered: the spmd step at (dp, ts) = (2, 1), (1, 2) and (2, 2) for NRMS
and NAML (word ids with the table trained, doc_table frozen), two steps,
against JAX's make_spmd_train_step and against the port's plain step on
the concatenated batch: loss and accuracy within rel 1e-5, every leaf
within rtol 1e-4 / atol 1e-6 (the JAX suite's, tests/test_sharding.py),
the table's rows gathered from the ranks; the multi step against k single
steps; the weighted partial batch with a whole data index of padding;
fit over shards of unequal length (the agreed step count); the sharded
news encoder; gather_rows_sharded at ts = 2 and 4, forward and backward;
cross_process_sum; a sharded checkpoint resumed at ts = 2 and ts = 1;
cli.main on two ranks (train_test, then test) against one process, its
checkpoint tested and served by one process; and cli.main's own launch.

Adam moves every element by about lr in its first steps, whatever the
size of its gradient, so the summation-order noise of an element whose
gradient is near 0 reaches its update: lr is 3e-4, as in the port's
other train-step tests, where that stays within the tolerance. The last
step's gradients, after the all-reduce, are held to the plain step's at
the JAX suite's gradient tolerance (rtol 1e-4 / atol 1e-5). The leaves whose gradient is 0 analytically (the key
bias of each MHSA and the score bias of each attention pooling) have a
gradient of rounding noise only, which Adam turns into updates of either
sign: they are held to a difference within 4 lr, as in
tests/test_torch_train_step.py; every other leaf to the tolerances above.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from newsrecommendation_tpu.parallel.sharded_embedding import (
    gather_rows_sharded as jax_gather,
)
from newsrecommendation_tpu.parallel.sharded_embedding import (
    shard_table as jax_shard_table,
)
from newsrecommendation_tpu.parallel.spmd import (
    make_spmd_train_step as jax_spmd_step,
)
from newsrecommendation_tpu.parallel.spmd import place_state as jax_place
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu_torch import cli
from newsrecommendation_tpu_torch.bridge import params_from_jax
from newsrecommendation_tpu_torch.ckpt import load_checkpoint
from newsrecommendation_tpu_torch.config import Config
from newsrecommendation_tpu_torch.data.synthetic import generate_corpus
from newsrecommendation_tpu_torch.eval import combine_metric_sums
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.serve import Recommender
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from tests.test_torch_cli import one_torch_thread  # noqa: F401

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
LEAF_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
VOCAB, DOCS, N_CAT, N_SUB = 31, 13, 4, 6
DIMS = dict(num_words_title=6, user_log_length=8, word_embedding_dim=16,
            news_dim=24, news_query_vector_dim=10, user_query_vector_dim=10,
            num_attention_heads=4, category_emb_dim=5, npratio=3,
            batch_size=4, drop_rate=0.0, deterministic=True, lr=3e-4,
            prefetch_depth=2)
MODELS = {
    "nrms": dict(model="NRMS", title_source="word_ids",
                 freeze_embedding=False),
    "naml_word": dict(model="NAML", title_source="word_ids",
                      use_category=True, use_subcategory=True,
                      freeze_embedding=False),
    "naml_doc": dict(model="NAML", title_source="doc_table",
                     use_category=True, use_subcategory=True,
                     freeze_embedding=True),
}
MESHES = ((2, 1), (1, 2), (2, 2))
ZERO_GRAD = {("news_encoder", "mhsa", "wk", "b"),
             ("user_encoder", "mhsa", "wk", "b"),
             ("news_encoder", "attn", "fc2", "b"),
             ("news_encoder", "final_attn", "fc2", "b"),
             ("user_encoder", "attn", "fc2", "b")}
CLI_TINY = ["--num_words_title", "6", "--user_log_length", "8",
            "--word_embedding_dim", "16", "--news_dim", "16",
            "--num_attention_heads", "4", "--news_query_vector_dim", "8",
            "--user_query_vector_dim", "8", "--filter_num", "0",
            "--batch_size", "8", "--lr", "0.003", "--log_steps", "50",
            "--eval_batch_size", "16", "--max_candidates", "16",
            "--deterministic", "True", "--epochs", "1", "--save_steps", "6"]


def case_cfg(model, **kw):
    kw = {**DIMS, **MODELS[model], **kw}
    return JaxConfig(**kw).replace(donate_state=False), Config(**kw)


def case_name(model, dp, ts):
    return f"{model}_{dp}x{ts}"


def make_table(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((VOCAB, jcfg.word_embedding_dim)
             if jcfg.title_source == "word_ids" else
             (DOCS, jcfg.num_words_title * jcfg.word_embedding_dim))
    table = rng.normal(size=shape).astype(np.float32)
    table[0] = 0.0
    return table


def jax_params(jcfg, ts, seed=0):
    """The JAX CLI's init: the table padded to a shard multiple first."""
    table = make_table(jcfg, seed)
    if ts > 1:
        table = jax_shard_table(table, ts)
    return jax_get_model(jcfg.model).init(jax.random.PRNGKey(seed), jcfg,
                                          table, N_CAT, N_SUB)


def features(jcfg, rows, rng):
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
    return np.concatenate(cols, axis=1).astype(np.int32)


def global_batch(jcfg, b, seed):
    """b rows: histories of every length (one empty), candidates of 1+K."""
    rng = np.random.default_rng(seed)
    L, k = jcfg.user_log_length, jcfg.npratio
    feats = features(jcfg, 40, rng)
    mask = np.zeros((b, L), np.float32)
    for i in range(b):
        n = (i * 3) % (L + 1)
        mask[i, L - n:] = 1.0
    return {"history": feats[rng.integers(0, 40, size=(b, L))],
            "history_mask": mask,
            "candidate": feats[rng.integers(0, 40, size=(b, 1 + k))],
            "label": rng.integers(0, 1 + k, size=(b,)).astype(np.int32),
            "weight": np.ones(b, np.float32)}


def partial_batch(jcfg, b, seed):
    """Row 1 of data index 0 weightless, data index 1 all padding (zero
    features, no history, weight 0), as the loader pads."""
    batch = global_batch(jcfg, b, seed)
    batch["weight"][1] = 0.0
    for v in batch.values():
        v[b // 2:] = 0
    return batch


def save_tree(path, tree):
    out = {}

    def walk(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + (k,))
        else:
            out["/".join(p)] = np.asarray(t)

    walk(tree)
    np.savez(path, **out)


def save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def trained_jax_state(jcfg):
    """A JAX state (table padded for two shards) after one step."""
    from newsrecommendation_tpu.train.step import make_train_step as jstep

    st = jax_state(jcfg, jax_params(jcfg, 2))
    b = {k: jnp.asarray(v) for k, v in global_batch(jcfg, 4, 21).items()}
    st, _ = jstep(jcfg, jax_get_model(jcfg.model))(st, b,
                                                   jax.random.PRNGKey(0))
    return st


def jax_adam(jst):
    """The Adam part (count, mu, nu) of a JAX state, as numpy."""
    from newsrecommendation_tpu_torch.bridge import _adam_part

    count, mu, nu = _adam_part(jst.opt_state)
    return jax.tree.map(np.asarray, {"count": count, "mu": mu, "nu": nu})


def port_kw(cfg):
    return {k: v for k, v in vars(cfg).items()}


def fit_inputs(jcfg):
    """Two shards of unequal length (10 and 5 samples: 3 and 2 batches of
    4) over a 25-news feature matrix."""
    rng = np.random.default_rng(9)
    L, k = jcfg.user_log_length, jcfg.npratio
    feats = np.concatenate([np.zeros((1, jcfg.news_feature_width), np.int32),
                            features(jcfg, 25, rng)])
    out = {"features": feats}
    for d, n in enumerate((10, 5)):
        hist = rng.integers(0, 26, size=(n, L)).astype(np.int32)
        mask = (rng.random((n, L)) > 0.3).astype(np.float32)
        hist[mask == 0] = 0
        out.update({f"history_{d}": hist, f"history_mask_{d}": mask,
                    f"pos_{d}": rng.integers(1, 26, size=n).astype(np.int32),
                    f"neg_{d}": rng.integers(1, 26, size=(n, k)).astype(
                        np.int32)})
    return out


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mp")
    jobs = {2: [], 4: []}
    for model in MODELS:
        for dp, ts in MESHES:
            jcfg, cfg = case_cfg(model)
            name = case_name(model, dp, ts)
            save_tree(d / f"{name}.params.npz",
                      jax.tree.map(np.asarray, jax_params(jcfg, ts)))
            save_batches(d / f"{name}.batches.npz",
                         [global_batch(jcfg, 4 * dp, s) for s in (1, 2)])
            jobs[dp * ts].append({"name": name, "kind": "step",
                                  "cfg": port_kw(cfg), "dp": dp, "ts": ts,
                                  "params": f"{name}.params.npz",
                                  "batches": f"{name}.batches.npz"})
    jcfg, cfg = case_cfg("nrms")
    for dp, ts in ((2, 1), (1, 2)):
        name = f"multi_{dp}x{ts}"
        save_batches(d / f"{name}.batches.npz",
                     [global_batch(jcfg, 4 * dp, s) for s in (5, 6, 7)])
        jobs[2].append({"name": name, "kind": "multi", "cfg": port_kw(cfg),
                        "dp": dp, "ts": ts,
                        "params": f"{case_name('nrms', dp, ts)}.params.npz",
                        "batches": f"{name}.batches.npz"})
    save_batches(d / "partial.batches.npz", [partial_batch(jcfg, 8, 3)])
    jobs[2].append({"name": "partial", "kind": "step", "cfg": port_kw(cfg),
                    "dp": 2, "ts": 1, "params": "nrms_2x1.params.npz",
                    "batches": "partial.batches.npz"})
    np.savez(d / "fit.npz", **fit_inputs(jcfg))
    jobs[2].append({"name": "fit", "kind": "fit",
                    "cfg": port_kw(cfg.replace(steps_per_call=2)),
                    "dp": 2, "ts": 1, "params": "nrms_2x1.params.npz",
                    "inputs": "fit.npz"})
    for model in ("nrms", "naml_doc"):
        jm, cm = case_cfg(model)
        np.savez(d / f"enc_{model}.npz", features=features(
            jm, 17, np.random.default_rng(4)))
        jobs[2].append({"name": f"encoder_{model}", "kind": "encoder",
                        "cfg": port_kw(cm), "dp": 1, "ts": 2,
                        "params": f"{case_name(model, 1, 2)}.params.npz",
                        "inputs": f"enc_{model}.npz"})
    for ts in (2, 4):
        rng = np.random.default_rng(ts)
        table = rng.normal(size=(jax_shard_table(
            np.zeros((VOCAB, 8), np.float32), ts).shape[0], 8)).astype(
                np.float32)
        ids = rng.integers(0, VOCAB, size=(5, 7)).astype(np.int32)
        ids[0, :3] = 3  # a row gathered three times
        np.savez(d / f"gather_{ts}.npz", table=table, ids=ids,
                 g=rng.normal(size=(5, 7, 8)).astype(np.float32))
        jobs[ts].append({"name": f"gather_{ts}", "kind": "gather",
                         "cfg": port_kw(cfg), "ts": ts,
                         "inputs": f"gather_{ts}.npz"})
    jobs[2].append({"name": "xsum", "kind": "xsum"})
    jobs[4].append({"name": "replicate", "kind": "replicate"})
    jst = trained_jax_state(jcfg)
    save_tree(d / "bridge.params.npz", jax.tree.map(np.asarray, jst.params))
    save_tree(d / "bridge.adam.npz", jax_adam(jst))
    jobs[2].append({"name": "bridge", "kind": "bridge", "cfg": port_kw(cfg),
                    "ts": 2, "params": "bridge.params.npz",
                    "adam": "bridge.adam.npz"})
    save_batches(d / "ckpt.batches.npz",
                 [global_batch(jcfg, 4, s) for s in (11, 12, 13)])
    jobs[2].append({"name": "ckpt", "kind": "ckpt", "cfg": port_kw(cfg),
                    "dp": 1, "ts": 2, "params": "nrms_1x2.params.npz",
                    "batches": "ckpt.batches.npz"})

    corpus = d / "corpus"
    generate_corpus(str(corpus / "train"), num_news=60, num_users=20,
                    num_impressions=120, seed=1, split="train")
    generate_corpus(str(corpus / "dev"), num_news=60, num_users=20,
                    num_impressions=60, seed=2, split="dev")
    for run in ("cli_sharded", "cli_spawn", "cli_plain", "cli_single"):
        shutil.copytree(corpus, d / run / "data")

    def argv(run, mode, *extra):
        return (["--mode", mode, "--train_data_dir",
                 str(d / run / "data" / "train"), "--test_data_dir",
                 str(d / run / "data" / "dev"), "--model_dir",
                 str(d / run / "model")] + CLI_TINY + list(extra))

    jobs[2].append({"name": "cli", "kind": "cli", "argvs": [
        argv("cli_sharded", "train_test", "--table_shards", "2"),
        argv("cli_sharded", "test", "--table_shards", "2",
             "--load_ckpt_name", "latest")]})
    with open(d / "spawn.json", "w", encoding="utf-8") as f:
        json.dump(argv("cli_spawn", "train", "--table_shards", "2"), f)
    for world, js in jobs.items():
        with open(d / f"jobs_{world}.json", "w", encoding="utf-8") as f:
            json.dump(js, f)

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmds = [[sys.executable, WORKER, str(r), str(w), str(d)]
            for w in (2, 4) for r in range(w)]
    cmds.append([sys.executable, WORKER, "spawn", str(d)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for c in cmds]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for c, p, (_, err) in zip(cmds, procs, outs):
        assert p.returncode == 0, f"{c[2:4]} failed:\n{err[-4000:]}"
    return d, argv


def result(d, name, rank):
    return torch.load(d / "out" / f"{name}.rank{rank}.pt",
                      weights_only=False)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def whole_params(d, name, dp, ts, key="params"):
    """The ranks' params as one tree: every leaf equal on every rank (bit
    for bit), the table's rows concatenated over the table group."""
    outs = [{key: result(d, name, r)[key]} for r in range(dp * ts)]
    tree = {}
    for flat_key in outs[0][key]:
        vals = [o[key][flat_key] for o in outs]
        if flat_key == "embedding_table" and ts > 1:
            for di in range(dp):
                for ti in range(ts):
                    assert torch.equal(vals[di * ts + ti], vals[ti])
            val = torch.cat(vals[:ts])
        else:
            for v in vals[1:]:
                assert torch.equal(v, vals[0]), flat_key
            val = vals[0]
        node = tree
        *head, last = flat_key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = val.numpy()
    return tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_leaves(got, want, lr, rows=None, label=""):
    for path, w in leaves(want):
        g = get(got, path)
        w = np.asarray(w)
        if path == ("embedding_table",) and rows is not None:
            g, w = g[:rows], w[:rows]
        if path in ZERO_GRAD:
            assert np.abs(g - w).max() < 4 * lr, (label, path)
            continue
        np.testing.assert_allclose(g, w, **LEAF_TOL,
                                   err_msg=f"{label} {path}")


def jax_run(jcfg, dp, ts, batches):
    """JAX's shard_map step on a (dp, ts) mesh of the first dp*ts CPU
    devices: (losses, accs, params)."""
    model = jax_get_model(jcfg.model)
    jcfg = jcfg.replace(data_parallel=dp, table_shards=ts)
    mesh = jax_make_mesh(jcfg, devices=jax.devices()[:dp * ts])
    st = jax_place(jax_state(jcfg, jax_params(jcfg, ts)), mesh, ts > 1)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    step = jax_spmd_step(jcfg, model, mesh, st, jb[0])
    losses, accs = [], []
    for b in jb:
        st, m = step(st, b, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    return losses, accs, jax.tree.map(np.asarray, st.params)


def plain_run(cfg, jparams, batches, device_gather=False, feats=None):
    """The port's single-process step over the concatenated batches."""
    state = create_train_state(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    step = make_train_step(cfg, get_model(cfg.model),
                           device_gather=device_gather)
    losses, accs = [], []
    extra = () if feats is None else (torch.from_numpy(feats),)
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in b.items()}, 0, *extra)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    return losses, accs, {p: v.detach().numpy() for p, v in
                          _nested(state.params).items()}, state


def _nested(tree, path=()):
    out = {}
    for p, v in leaves(tree):
        out[p] = v
    return out


def as_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


CASES = [(m, dp, ts) for m in MODELS for dp, ts in MESHES]


@pytest.mark.parametrize("against", ["jax", "plain"])
@pytest.mark.parametrize("model, dp, ts", CASES,
                         ids=[case_name(*c) for c in CASES])
def test_spmd_step(mp_run, model, dp, ts, against):
    """Two spmd steps on (dp, ts) ranks against JAX's shard_map step on
    the same mesh shape, and against the port's plain step on the
    concatenated batch: loss, accuracy, every leaf, the table's rows."""
    d, _ = mp_run
    jcfg, cfg = case_cfg(model)
    name = case_name(model, dp, ts)
    batches = [global_batch(jcfg, 4 * dp, s) for s in (1, 2)]
    out = result(d, name, 0)
    assert out["step"] == 2
    if against == "jax":
        losses, accs, want = jax_run(jcfg, dp, ts, batches)
    else:
        losses, accs, flat, _ = plain_run(cfg, jax_params(jcfg, ts), batches)
        want = as_tree(flat)
    np.testing.assert_allclose(out["loss"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["acc"], accs, rtol=LOSS_RTOL)
    rows = VOCAB if jcfg.title_source == "word_ids" else DOCS
    assert_leaves(whole_params(d, name, dp, ts), want, cfg.lr, rows, name)
    if against == "plain":
        state = plain_run(cfg, jax_params(jcfg, ts), batches)[3]
        grads = whole_params(d, name, dp, ts, key="grads")
        for path, p in leaves(state.params):
            if p.grad is None:
                assert path == ("embedding_table",) and cfg.freeze_embedding
                continue
            np.testing.assert_allclose(get(grads, path), p.grad.numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} grad {path}")
    if not cfg.freeze_embedding:
        assert not np.array_equal(
            whole_params(d, name, dp, ts)["embedding_table"][:rows],
            make_table(jcfg)[:rows])


@pytest.mark.parametrize("dp, ts", [(2, 1), (1, 2)])
def test_multi_step_matches_single_steps(mp_run, dp, ts):
    d, _ = mp_run
    name = f"multi_{dp}x{ts}"
    out = result(d, name, 0)
    assert out["multi_step"] == 3
    np.testing.assert_allclose(out["multi_loss"][-1], out["single_loss"],
                               rtol=1e-6)
    multi = whole_params(d, name, dp, ts, key="multi")
    single = whole_params(d, name, dp, ts, key="single")
    for path, v in leaves(single):
        np.testing.assert_allclose(get(multi, path), v, rtol=1e-6, atol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("against", ["jax", "plain"])
def test_weighted_partial_batch_exact(mp_run, against):
    """Padding that lands unevenly (one row of data index 0, all of data
    index 1): the globally weighted loss and step are the one-device
    ones, and the all-padding rank adds nothing and no NaN."""
    d, _ = mp_run
    jcfg, cfg = case_cfg("nrms")
    batch = [partial_batch(jcfg, 8, 3)]
    out = result(d, "partial", 0)
    if against == "jax":
        losses, _, want = jax_run(jcfg, 2, 1, batch)
    else:
        losses, _, flat, _ = plain_run(cfg, jax_params(jcfg, 1), batch)
        want = as_tree(flat)
    assert np.isfinite(out["loss"]).all()
    np.testing.assert_allclose(out["loss"], losses, rtol=LOSS_RTOL)
    assert_leaves(whole_params(d, "partial", 2, 1), want, cfg.lr, VOCAB)


def test_fit_agrees_on_the_step_count(mp_run):
    """fit over shards of 3 and 2 batches (k = 2 steps a call): both ranks
    take 3 steps, the short one a padding batch last, and end where the
    plain step over the concatenated batches ends."""
    from newsrecommendation_tpu_torch.data.loader import TrainSamples
    from newsrecommendation_tpu_torch.train.loop import _padding_batch

    d, _ = mp_run
    jcfg, cfg = case_cfg("nrms")
    outs = [result(d, "fit", r) for r in range(2)]
    assert [o["step"] for o in outs] == [3, 3]
    assert [o["stats"]["steps"] for o in outs] == [3, 3]
    assert outs[0]["stats"]["examples"] == 10
    assert outs[1]["stats"]["examples"] == 5
    inputs = fit_inputs(jcfg)
    shards = []
    for i in range(2):
        samples = TrainSamples(**{k: inputs[f"{k}_{i}"] for k in (
            "history", "history_mask", "pos", "neg")})
        own = list(samples.iter_index_batches(4, epoch=0, seed=cfg.seed))
        shards.append(own + [_padding_batch(cfg, None, True)] * (
            3 - len(own)))
    batches = [{k: np.concatenate([a[k], b[k]]) for k in a}
               for a, b in zip(*shards)]
    losses, _, flat, _ = plain_run(cfg, jax_params(jcfg, 1), batches,
                                   device_gather=True,
                                   feats=inputs["features"])
    np.testing.assert_allclose(outs[0]["stats"]["final_loss"], losses[-1],
                               rtol=LOSS_RTOL)
    assert_leaves(whole_params(d, "fit", 2, 1), as_tree(flat), cfg.lr, VOCAB)


@pytest.mark.parametrize("model", ["nrms", "naml_doc"])
def test_sharded_news_encoder_matches_dense(mp_run, model):
    d, _ = mp_run
    jcfg, cfg = case_cfg(model)
    feats = features(jcfg, 17, np.random.default_rng(4))
    jparams = jax_params(jcfg, 2)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.inference_mode():
        want = get_model(cfg.model).news_encoder(params, cfg,
                                                 torch.from_numpy(feats))
    jwant = jax_get_model(jcfg.model).news_encoder(jparams, jcfg,
                                                   jnp.asarray(feats))
    for r in range(2):
        got = result(d, f"encoder_{model}", r)["vecs"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ts", [2, 4])
def test_gather_rows_sharded(mp_run, ts):
    """Rows on every rank equal the dense take and JAX's gather under
    shard_map; the local gradients, concatenated, equal the dense
    scatter-add (a row gathered three times takes three terms) and JAX's
    gradient through its psum."""
    d, _ = mp_run
    with np.load(d / f"gather_{ts}.npz") as z:
        table, ids, g = z["table"], z["ids"], z["g"]
    want_grad = np.zeros_like(table)
    np.add.at(want_grad, ids.reshape(-1), g.reshape(-1, 8))
    mesh = jax_make_mesh(data_parallel=1, table_shards=ts,
                         devices=jax.devices()[:ts])
    P = jax.sharding.PartitionSpec
    mapped = shard_map(lambda t, i: jax_gather(t, i, "table"), mesh=mesh,
                       in_specs=(P("table", None), P()), out_specs=P(),
                       check_vma=False)
    jrows = mapped(jnp.asarray(table), jnp.asarray(ids))
    jgrad = jax.grad(lambda t: jnp.sum(mapped(t, jnp.asarray(ids))
                                       * jnp.asarray(g)))(jnp.asarray(table))
    outs = [result(d, f"gather_{ts}", r) for r in range(ts)]
    for o in outs:
        np.testing.assert_allclose(o["rows"].numpy(), table[ids], rtol=1e-6)
        np.testing.assert_allclose(o["rows"].numpy(), np.asarray(jrows),
                                   rtol=1e-6)
    grad = np.concatenate([o["grad"].numpy() for o in outs])
    np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def test_cross_process_sum(mp_run):
    d, _ = mp_run
    outs = [result(d, "xsum", r) for r in range(2)]
    want = combine_metric_sums([o["local"] for o in outs])
    for o in outs:
        assert set(o["total"]) == set(want)
        for k, v in want.items():
            assert o["total"][k] == pytest.approx(v, rel=1e-15), k


def test_sharded_checkpoint_resumes(mp_run):
    """Saved at ts = 2 after two steps: the sidecar lists the table's
    leaves, each rank wrote its shard; resumed at ts = 2 the third step
    equals the run that went through, bit for bit; resumed at ts = 1 (one
    process, the unpadded table) and the unsharded run agree with it."""
    d, _ = mp_run
    jcfg, cfg = case_cfg("nrms")
    out = result(d, "ckpt", 0)
    assert out["resumed_step"] == 2
    assert out["sidecar"]["sharded_leaves"] == [
        "opt_state/embedding_table/exp_avg",
        "opt_state/embedding_table/exp_avg_sq", "params/embedding_table"]
    path = d / "ckpt" / "epoch-1-2.ckpt"
    assert sorted(os.listdir(d / "ckpt")) == [
        "epoch-1-2.ckpt", "epoch-1-2.ckpt.json", "epoch-1-2.ckpt.shards0.pt",
        "epoch-1-2.ckpt.shards1.pt"]
    through = whole_params(d, "ckpt", 1, 2, key="through")
    resumed = whole_params(d, "ckpt", 1, 2, key="resumed")
    for path_, v in leaves(through):
        assert np.array_equal(get(resumed, path_), v), path_
    batches = [global_batch(jcfg, 4, s) for s in (11, 12, 13)]
    jparams = jax_params(jcfg, 1)  # the unpadded table
    _, _, flat, _ = plain_run(cfg, jparams, batches)
    assert_leaves(through, as_tree(flat), cfg.lr, VOCAB, "unsharded")
    template = create_train_state(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    state, _ = load_checkpoint(str(path), template, cfg)
    assert state.params["embedding_table"].shape[0] == VOCAB
    step = make_train_step(cfg, get_model("NRMS"))
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                            batches[2].items()}, 0)
    got = {p: v.detach().numpy() for p, v in _nested(state.params).items()}
    assert_leaves(as_tree(got), through, cfg.lr, VOCAB, "ts=1")


def eval_lines(model_dir):
    with open(os.path.join(model_dir, "metrics.jsonl"),
              encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    return [x for x in lines if x["kind"] == "eval"]


def test_cli_two_ranks_train_test_then_test(mp_run, one_torch_thread):
    """cli.main on two gloo ranks with --table_shards 2 (the word table
    trained): one metrics.jsonl with the train lines and two eval lines
    (train_test, then test from latest), the shard files beside each
    checkpoint; the eval line repeated by one process's --mode test from
    that checkpoint (one thread, as the ranks: the scores' bits, and so
    the rank order of near ties, are the same); the checkpoint served by
    one process, as an unsharded run's."""
    d, argv = mp_run
    model_dir = d / "cli_sharded" / "model"
    files = sorted(os.listdir(model_dir))
    for ck in [f for f in files if f.endswith(".ckpt")]:
        assert f"{ck}.shards0.pt" in files and f"{ck}.shards1.pt" in files
    sharded = eval_lines(model_dir)
    assert len(sharded) == 2
    cli.main(argv("cli_plain", "train_test"), device="cpu")
    (plain,) = eval_lines(d / "cli_plain" / "model")
    shutil.copytree(model_dir, d / "cli_single" / "model",
                    dirs_exist_ok=True)
    os.remove(d / "cli_single" / "model" / "metrics.jsonl")
    cli.main(argv("cli_single", "test", "--load_ckpt_name", "latest"),
             device="cpu")
    (single,) = eval_lines(d / "cli_single" / "model")
    for k in ("auc", "mrr", "ndcg5", "ndcg10"):
        assert sharded[0][k] == pytest.approx(sharded[1][k], abs=1e-4), k
        assert single[k] == pytest.approx(sharded[1][k], abs=1e-4), k
    assert single["samples"] == sharded[1]["samples"] == plain["samples"]

    cfg = cli.config_from_args(argv("cli_plain", "test"))
    data = str(d / "cli_plain" / "data" / "dev")
    recs = [Recommender.from_checkpoint(
        str(m / "epoch-1.ckpt"), cfg, data, device="cpu")
        for m in (model_dir, d / "cli_plain" / "model")]
    hist = [["N1", "N2", "N3"], ["N4"]]
    cands = [["N5", "N6", "N7"], ["N8", "N9"]]
    a, b = (r.score_batch(hist, cands) for r in recs)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-3,
                                   atol=1e-4)


def test_cli_spawns_its_own_ranks(mp_run):
    """cli.main with --table_shards 2 and no process group on the CPU
    spawns its two ranks (torch.multiprocessing): the checkpoint has both
    shard files and the same params as the two joined ranks' run."""
    d, argv = mp_run
    files = os.listdir(d / "cli_spawn" / "model")
    assert {"epoch-1.ckpt.shards0.pt", "epoch-1.ckpt.shards1.pt"} <= set(
        files)
    def params(model_dir):
        blob = torch.load(model_dir / "epoch-1.ckpt", weights_only=True)
        shards = [torch.load(model_dir / f"epoch-1.ckpt.shards{i}.pt",
                             weights_only=True) for i in range(2)]
        return blob["params"], torch.cat(
            [s["params/embedding_table"] for s in shards])

    (p1, t1), (p2, t2) = (params(d / r / "model")
                          for r in ("cli_spawn", "cli_sharded"))
    torch.testing.assert_close(t1, t2, rtol=1e-6, atol=1e-7)
    for (path, a), (_, b) in zip(leaves(p1), leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                   msg=str(path))


def test_replicate_broadcasts_and_checks(mp_run):
    """replicate on four ranks: every leaf becomes rank 0's; the check
    mode passes on that tree and raises on one the ranks hold apart."""
    d, _ = mp_run
    outs = [result(d, "replicate", r) for r in range(4)]
    for o in outs:
        assert torch.equal(o["tree"]["a"], torch.zeros(3))
        assert torch.equal(o["tree"]["b/c"], torch.arange(4.0))
    assert [o["raised"] for o in outs] == [False, True, True, True]


def test_bridge_on_a_mesh_round_trips(mp_run):
    """A JAX state after a step, its table padded for two shards, bridged
    onto a (1, 2) mesh (each rank its rows) and back: the whole params,
    table and Adam moments included, on every rank, bit for bit."""
    d, _ = mp_run
    jcfg, _ = case_cfg("nrms")
    jst = trained_jax_state(jcfg)
    adam = jax_adam(jst)
    want = jax.tree.map(np.asarray, jst.params)
    for r in range(2):
        o = result(d, "bridge", r)
        assert o["step"] == 3 and o["local_rows"] == 16
        for path, v in leaves(want):
            np.testing.assert_array_equal(get(o["params"], path), v,
                                          err_msg=str(path))
        for key in ("mu", "nu"):
            for path, v in leaves(adam[key]):
                np.testing.assert_array_equal(get(o["adam"][key], path), v,
                                              err_msg=f"{key} {path}")
