"""The port's mesh, row-sharded table and data-parallel step pieces that
run in one process, on the CPU, against the JAX package's
(newsrecommendation_tpu/parallel/) where it has the same piece: the mesh's
shape and rank layout, the padded table and its shards, the masked local
gather and its scatter-add backward summed over the shards, the
autograd Function in a one-rank gloo group, the spmd step on a one-rank
mesh against the plain step, the state placement, sharded checkpoints
written by each rank and loaded at other shard counts, the flags.

The runs of several ranks are in tests/test_torch_parallel_mp.py.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from newsrecommendation_tpu.config import Config as JaxConfig
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from newsrecommendation_tpu.parallel.sharded_embedding import (
    gather_rows_sharded as jax_gather,
)
from newsrecommendation_tpu.parallel.sharded_embedding import (
    padded_rows as jax_padded_rows,
)
from newsrecommendation_tpu.parallel.sharded_embedding import (
    shard_table as jax_shard_table,
)
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.bridge import (
    params_from_jax,
    state_from_jax,
)
from newsrecommendation_tpu_torch.ckpt import (
    load_checkpoint,
    save_checkpoint,
)
from newsrecommendation_tpu_torch.config import (
    Config,
    check_supported,
    config_from_args,
)
from newsrecommendation_tpu_torch.eval import cross_process_sum
from newsrecommendation_tpu_torch.models import common, get_model
from newsrecommendation_tpu_torch.parallel import mesh as pmesh
from newsrecommendation_tpu_torch.parallel import sharded_embedding as se
from newsrecommendation_tpu_torch.parallel.spmd import (
    make_spmd_train_step,
    place_state,
    table_lookup,
)
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from newsrecommendation_tpu_torch.train.loop import (
    _padding_batch,
    agreed_batch_count,
)
from newsrecommendation_tpu_torch.train.step import _dropout_generator

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

VOCAB = 31
# the leaves whose gradient is 0 analytically (tests/test_torch_train_step.py)
ZERO_GRAD = {("news_encoder", "mhsa", "wk", "b"),
             ("user_encoder", "mhsa", "wk", "b"),
             ("news_encoder", "attn", "fc2", "b"),
             ("user_encoder", "attn", "fc2", "b")}
DIMS = dict(num_words_title=6, user_log_length=8, word_embedding_dim=16,
            news_dim=24, news_query_vector_dim=10, user_query_vector_dim=10,
            num_attention_heads=4, category_emb_dim=5, npratio=3,
            batch_size=4, lr=3e-4)


def cfgs(model="NRMS", **kw):
    kw = {**DIMS, "model": model, **kw}
    return JaxConfig(**kw).replace(donate_state=False), Config(**kw)


def make_table(rows=VOCAB, dim=16, seed=0):
    t = np.random.default_rng(seed).normal(size=(rows, dim)).astype(
        np.float32)
    t[0] = 0.0
    return t


def batch_of(cfg, b=4, seed=1):
    rng = np.random.default_rng(seed)
    L, k, T = cfg.user_log_length, cfg.npratio, cfg.num_words_title
    mask = (rng.random((b, L)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    return {"history": rng.integers(0, VOCAB, size=(b, L, T)).astype(
                np.int32),
            "history_mask": mask,
            "candidate": rng.integers(0, VOCAB, size=(b, 1 + k, T)).astype(
                np.int32),
            "label": rng.integers(0, k + 1, size=(b,)).astype(np.int32),
            "weight": np.ones(b, np.float32)}


def t_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


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
def one_rank_group(tmp_path):
    """A gloo group of one rank through a file, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


# ---- the mesh -------------------------------------------------------------

@pytest.mark.parametrize("dp, ts", [(0, 1), (0, 2), (0, 4), (2, 2), (1, 4),
                                    (8, 1), (3, 2)])
def test_mesh_shape_as_jax(dp, ts):
    """mesh_shape sizes the mesh as JAX's make_mesh over eight devices:
    data_parallel 0 takes the devices left after table sharding."""
    jm = jax_make_mesh(data_parallel=dp, table_shards=ts)
    assert pmesh.mesh_shape(dp, ts, 8) == tuple(jm.devices.shape)


@pytest.mark.parametrize("dp, ts, match", [
    (4, 4, "needs 16 devices, have 8"), (0, 3, "must divide 8 devices"),
    (9, 1, "needs 9 devices, have 8")])
def test_mesh_larger_than_the_devices_raises(dp, ts, match):
    with pytest.raises(ValueError, match=match):
        pmesh.mesh_shape(dp, ts, 8)
    with pytest.raises(ValueError, match=match.split(",")[0]):
        jax_make_mesh(data_parallel=dp, table_shards=ts)


@pytest.mark.parametrize("dp, ts", [(2, 1), (1, 2), (2, 2), (4, 2), (2, 4)])
def test_rank_layout_is_the_jax_mesh(dp, ts):
    """Rank r sits where JAX's mesh puts device r: data index r // ts,
    table index r % ts; a data group is a column of the mesh, a table
    group a row."""
    grid = jax_make_mesh(data_parallel=dp, table_shards=ts,
                         devices=jax.devices()[:dp * ts]).devices
    for d in range(dp):
        for t in range(ts):
            m = pmesh.Mesh(dp, ts, int(grid[d, t].id), torch.device("cpu"))
            assert (m.data_index, m.table_index) == (d, t)
            assert m.world == dp * ts and not m.trivial


def test_make_mesh_without_a_group():
    assert not dist.is_initialized()
    m = pmesh.make_mesh(Config(), device="cpu")
    assert (m.dp, m.ts, m.rank, m.world) == (1, 1, 0, 1) and m.trivial
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        pmesh.make_mesh(data_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="must divide 1 devices"):
        pmesh.make_mesh(table_shards=2, device="cpu")


def test_make_mesh_in_a_one_rank_group(one_rank_group):
    m = pmesh.make_mesh(Config(), device="cpu")
    assert (m.dp, m.ts) == (1, 1) and not m.trivial
    assert m.data_group is not None and m.table_group is not None
    assert cross_process_sum({"auc": 0.5, "count": 2.0}) == {
        "auc": 0.5, "count": 2.0}


def test_feed_slicing():
    mesh = pmesh.Mesh(4, 2, 5, torch.device("cpu"))
    assert pmesh.owned_data_rows(mesh) == [2]
    assert pmesh.local_batch_size(mesh, 32) == 8
    assert pmesh.local_batch_size(None, 32) == 32
    with pytest.raises(ValueError, match="does not split"):
        pmesh.local_batch_size(mesh, 30)
    rows = {"x": np.arange(32).reshape(16, 2)}
    np.testing.assert_array_equal(pmesh.shard_batch(mesh, rows)["x"],
                                  np.arange(16, 24).reshape(4, 2))
    assert pmesh.device_slots("cpu", 0, 2) == 2
    assert pmesh.device_slots("cpu", 3, 2) == 6


# ---- the row-sharded table ------------------------------------------------

@pytest.mark.parametrize("n, s", [(31, 1), (31, 2), (31, 4), (32, 4),
                                  (5, 8)])
def test_padded_table_and_shards_as_jax(n, s):
    table = make_table(n, 3)
    assert se.padded_rows(n, s) == jax_padded_rows(n, s)
    padded = se.shard_table(table, s)
    np.testing.assert_array_equal(padded, jax_shard_table(table, s))
    r = padded.shape[0] // s
    for i in range(s):
        part = padded[i * r:(i + 1) * r]
        np.testing.assert_array_equal(se.local_rows(table, s, i), part)
        np.testing.assert_array_equal(
            se.local_rows(torch.from_numpy(table), s, i).numpy(), part)


@pytest.mark.parametrize("ts", [1, 2, 4])
def test_masked_local_gather_sums_to_the_jax_gather(ts):
    """Each shard's masked local take, summed over the shards (what the
    all-reduce does), is the dense take and JAX's gather_rows_sharded
    under shard_map on ts devices; each shard's masked scatter-add of the
    output gradient, concatenated, is the dense gradient and JAX's
    (a row gathered three times takes three terms)."""
    rng = np.random.default_rng(ts)
    table = se.shard_table(make_table(VOCAB, 8, ts), ts)
    ids = rng.integers(0, VOCAB, size=(5, 7)).astype(np.int32)
    ids[0, :3] = 3
    g = rng.normal(size=(5, 7, 8)).astype(np.float32)
    r = table.shape[0] // ts
    rows = sum(se.masked_local_take(torch.from_numpy(table[i * r:(i + 1) * r]),
                                    torch.from_numpy(ids), i * r)
               for i in range(ts))
    grad = torch.cat([se.masked_local_scatter(
        torch.from_numpy(g), torch.from_numpy(ids), r, i * r, torch.float32)
        for i in range(ts)])
    mesh = jax_make_mesh(data_parallel=1, table_shards=ts,
                         devices=jax.devices()[:ts])
    P = jax.sharding.PartitionSpec
    mapped = shard_map(lambda t, i: jax_gather(t, i, "table"), mesh=mesh,
                       in_specs=(P("table", None), P()), out_specs=P(),
                       check_vma=False)
    jrows = mapped(jnp.asarray(table), jnp.asarray(ids))
    jgrad = jax.grad(lambda t: jnp.sum(mapped(t, jnp.asarray(ids))
                                       * jnp.asarray(g)))(jnp.asarray(table))
    dense = np.zeros_like(table)
    np.add.at(dense, ids.reshape(-1), g.reshape(-1, 8))
    np.testing.assert_array_equal(rows.numpy(), table[ids])
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), dense, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_function_in_a_one_rank_group(one_rank_group, dtype):
    """gather_rows_sharded on a one-rank table group is the dense take,
    and its backward the dense gradient (summed in f32, then cast)."""
    mesh = pmesh.make_mesh(Config(), device="cpu")
    table = torch.from_numpy(make_table(VOCAB, 8)).to(dtype)
    ids = torch.from_numpy(
        np.random.default_rng(3).integers(0, VOCAB, size=(4, 6)))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out = se.gather_rows_sharded(a, ids, mesh)
    ref = b[ids]
    assert torch.equal(out, ref)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 6, 8)).astype(np.float32)).to(dtype)
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(a.grad.float(), b.grad.float(),
                               rtol=2 ** -7, atol=2 ** -7)


# ---- the models' lookup and the step ----------------------------------------

@pytest.mark.parametrize("model", ["NRMS", "NAML"])
def test_forward_takes_a_lookup(model):
    """forward hands its lookup to the news encoder (the JAX models'
    ``lookup`` argument): a counting wrapper of the dense gather gives the
    default forward's loss and scores, and is called once per forward."""
    jcfg, cfg = cfgs(model, deterministic=True)
    jparams = jax_get_model(model).init(jax.random.PRNGKey(0), jcfg,
                                        make_table())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = t_batch(batch_of(cfg))
    calls = []

    def lookup(table, ids):
        calls.append(ids.shape)
        return common.default_lookup(table, ids)

    m = get_model(model)
    want = m.forward(params, cfg, batch)
    got = m.forward(params, cfg, batch, lookup=lookup)
    assert len(calls) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dropout_stream_per_data_index():
    """One data index keeps the plain step's dropout stream; each data
    index of a wider mesh has its own (data index 0 the plain one:
    SeedSequence reads a trailing 0 of its entropy as absent)."""
    def draw(shard):
        gen = _dropout_generator("cpu", 7, 3, shard)
        return torch.rand(16, generator=gen)

    key = np.random.SeedSequence([7, 3]).generate_state(1, np.uint64)
    plain = torch.rand(16, generator=torch.Generator().manual_seed(
        int(key[0])))
    assert torch.equal(draw(None), plain)
    assert torch.equal(draw(0), plain)
    assert not torch.equal(draw(0), draw(1))


@pytest.mark.parametrize("deterministic", [True, False])
def test_spmd_step_on_one_rank_is_the_plain_step(deterministic):
    """The spmd step on a one-rank mesh (its collectives the identity)
    takes the plain step's dropout draws and matches it: loss, accuracy,
    every leaf after two Adam steps."""
    _, cfg = cfgs(deterministic=deterministic, drop_rate=0.2,
                  freeze_embedding=False)
    mesh = pmesh.Mesh(1, 1, 0, torch.device("cpu"))
    model = get_model("NRMS")
    params = model.init(cfg, make_table(), seed=0, device="cpu")
    a = create_train_state(cfg, {k: v for k, v in params.items()})
    b = place_state(a, cfg, mesh)
    plain, spmd = (make_train_step(cfg, model),
                   make_spmd_train_step(cfg, model, mesh))
    for seed in (1, 2):
        batch = batch_of(cfg, seed=seed)
        batch["weight"][-1] = 0.0
        a, ma = plain(a, t_batch(batch), 5)
        b, mb = spmd(b, t_batch(batch), 5)
        assert float(mb["loss"]) == pytest.approx(float(ma["loss"]),
                                                  rel=1e-6)
        assert float(mb["acc"]) == pytest.approx(float(ma["acc"]), rel=1e-6)
    for path, v in leaves(a.params):
        if path in ZERO_GRAD:  # rounding noise, which Adam turns into +-lr
            diff = (get(b.params, path) - v).detach().abs().max()
            assert float(diff) < 4 * cfg.lr
            continue
        torch.testing.assert_close(get(b.params, path), v, rtol=1e-5,
                                   atol=1e-7, msg=str(path))


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_padding_batch_adds_nothing(user_log_mask):
    """The all-padding batch a short shard feeds (weight 0, no history)
    gives loss 0 and zero, finite gradients, as the loader's padded rows
    do: the fully masked history gives 0, not NaN."""
    _, cfg = cfgs(deterministic=True, user_log_mask=user_log_mask,
                  freeze_embedding=False)
    model = get_model("NRMS")
    state = create_train_state(cfg, model.init(cfg, make_table(), seed=0,
                                               device="cpu"))
    for device_gather in (False, True):
        feats = np.zeros((5, cfg.news_feature_width), np.int32)
        batch = _padding_batch(cfg, feats, device_gather)
        assert batch["weight"].shape == (cfg.batch_size,)
        if device_gather:
            continue
        loss, scores = model.forward(state.params, cfg, t_batch(batch))
        loss.backward()
        assert float(loss.detach()) == 0.0 and torch.isfinite(scores).all()
        for _, p in leaves(state.params):
            if p.grad is not None:  # pad_doc is off the masked path
                assert torch.isfinite(p.grad).all()
                assert float(p.grad.abs().max()) == 0.0


def test_agreed_batch_count_without_a_mesh():
    class S:
        num_samples = 10

    assert agreed_batch_count(S(), 4, None, "cpu") == 3
    assert agreed_batch_count(S(), 5, pmesh.Mesh(1, 1, 0, "cpu"), "cpu") == 2


# ---- state placement, checkpoints, the bridge ------------------------------

def trained_state(cfg, steps=2):
    """A whole state after two plain steps with the word table trained."""
    model = get_model("NRMS")
    state = create_train_state(cfg, model.init(cfg, make_table(), seed=0,
                                               device="cpu"))
    step = make_train_step(cfg, model)
    for seed in range(steps):
        state, _ = step(state, t_batch(batch_of(cfg, seed=seed)), 0)
    return state


def moments(state, leaf):
    return state.optimizer.state[leaf]


@pytest.mark.parametrize("ts", [2, 4])
def test_place_state_cuts_the_table_and_its_moments(ts):
    _, cfg = cfgs(deterministic=True, freeze_embedding=False)
    whole = trained_state(cfg)
    table = whole.params["embedding_table"]
    for t in range(ts):
        st = place_state(whole, cfg, pmesh.Mesh(1, ts, t, "cpu"))
        local = st.params["embedding_table"]
        assert torch.equal(local, se.local_rows(table.detach(), ts, t))
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments(st, local)[key], se.local_rows(
                moments(whole, table)[key], ts, t))
        for path, v in leaves(whole.params):
            if path != ("embedding_table",):
                w = get(st.params, path)
                assert torch.equal(w, v) and w.data_ptr() != v.data_ptr()
                assert torch.equal(moments(st, w)["exp_avg"],
                                   moments(whole, v)["exp_avg"])
        assert st.step == whole.step


def write_sharded(tmp_path, cfg, whole, ts, name="epoch-1.ckpt"):
    """Every rank of a (1, ts) mesh saves its placed state (no collective
    is needed to save)."""
    for t in range(ts):
        mesh = pmesh.Mesh(1, ts, t, "cpu")
        save_checkpoint(str(tmp_path), name, place_state(whole, cfg, mesh),
                        cfg, mesh=mesh, word_dict={"w": 1})
    return str(tmp_path / name)


@pytest.mark.parametrize("ts_load", [1, 2, 3, 4])
def test_sharded_checkpoint_loads_at_any_shard_count(tmp_path, ts_load):
    """Saved at ts = 2: rank 0 writes the main file (no table in it) and
    the sidecar, each rank its shard; loaded at ts = 1 the whole state
    comes back bit for bit, at ts = 2, 3 and 4 each rank's placed state."""
    _, cfg = cfgs(deterministic=True, freeze_embedding=False)
    whole = trained_state(cfg)
    path = write_sharded(tmp_path, cfg, whole, 2)
    blob = torch.load(path, weights_only=True)
    assert blob["params"]["embedding_table"].shape == ()
    import json

    with open(path + ".json", encoding="utf-8") as f:
        assert json.load(f)["sharded_leaves"] == [
            "opt_state/embedding_table/exp_avg",
            "opt_state/embedding_table/exp_avg_sq", "params/embedding_table"]
    model = get_model("NRMS")
    for t in range(ts_load):
        mesh = None if ts_load == 1 else pmesh.Mesh(1, ts_load, t, "cpu")
        fresh = create_train_state(cfg, model.init(cfg, make_table(), seed=1,
                                                   device="cpu"))
        want = whole
        if mesh is not None:
            fresh = place_state(fresh, cfg, mesh)
            want = place_state(whole, cfg, mesh)
        got, sidecar = load_checkpoint(path, fresh, cfg, mesh=mesh)
        assert got.step == whole.step and sidecar["word_dict"] == {"w": 1}
        for p, v in leaves(want.params):
            g = get(got.params, p)
            assert torch.equal(g, v), p
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(moments(got, g)[key],
                                   moments(want, v)[key]), (p, key)


def test_unsharded_checkpoint_loads_into_shards(tmp_path):
    _, cfg = cfgs(deterministic=True, freeze_embedding=False)
    whole = trained_state(cfg)
    path = save_checkpoint(str(tmp_path), "epoch-1.ckpt", whole, cfg)
    model = get_model("NRMS")
    mesh = pmesh.Mesh(1, 2, 1, "cpu")
    fresh = place_state(create_train_state(cfg, model.init(
        cfg, make_table(), seed=1, device="cpu")), cfg, mesh)
    got, _ = load_checkpoint(path, fresh, cfg, mesh=mesh)
    want = place_state(whole, cfg, mesh)
    t = got.params["embedding_table"]
    assert torch.equal(t, want.params["embedding_table"])
    assert torch.equal(moments(got, t)["exp_avg_sq"], moments(
        want, want.params["embedding_table"])["exp_avg_sq"])


def test_missing_shard_file_raises(tmp_path):
    _, cfg = cfgs(deterministic=True, freeze_embedding=False)
    whole = trained_state(cfg)
    path = write_sharded(tmp_path, cfg, whole, 2)
    (tmp_path / "epoch-1.ckpt.shards1.pt").unlink()
    fresh = create_train_state(cfg, get_model("NRMS").init(
        cfg, make_table(), seed=1, device="cpu"))
    with pytest.raises(FileNotFoundError, match="shards1.pt is missing"):
        load_checkpoint(path, fresh, cfg)


def test_frozen_table_is_not_sharded(tmp_path):
    """A frozen table stays out of every file; the sidecar lists no
    sharded leaf."""
    _, cfg = cfgs(deterministic=True, freeze_embedding=True)
    whole = trained_state(cfg)
    write_sharded(tmp_path, cfg, whole, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch-1.ckpt", "epoch-1.ckpt.json"]


def test_state_from_jax_on_a_mesh_is_the_ranks_share():
    """A JAX state (its table padded, moments after one step) bridged
    onto rank t of a (1, 2) mesh: that rank's rows of the table and of
    its moments, every other leaf whole."""
    jcfg, cfg = cfgs(deterministic=True, freeze_embedding=False,
                     table_shards=2)
    jparams = jax_get_model("NRMS").init(
        jax.random.PRNGKey(0), jcfg, jax_shard_table(make_table(), 2))
    jst = jax_state(jcfg, jparams)
    jb = {k: jnp.asarray(v) for k, v in batch_of(cfg).items()}
    jst, _ = jax_step(jcfg, jax_get_model("NRMS"))(jst, jb,
                                                   jax.random.PRNGKey(0))
    whole = state_from_jax(jax.tree.map(np.asarray, jst.params),
                           jst.opt_state, cfg, device="cpu")
    for t in range(2):
        mesh = pmesh.Mesh(1, 2, t, "cpu")
        st = state_from_jax(jax.tree.map(np.asarray, jst.params),
                            jst.opt_state, cfg, device="cpu", mesh=mesh)
        want = place_state(whole, cfg, mesh)
        for p, v in leaves(want.params):
            g = get(st.params, p)
            assert torch.equal(g, v), p
            assert torch.equal(moments(st, g)["exp_avg"],
                               moments(want, v)["exp_avg"]), p


# ---- the flags --------------------------------------------------------------

def test_flags_are_accepted():
    """--data_parallel, --nGPU and --table_shards above 1 parse and pass
    check_supported on either device; the other refusals stay."""
    cfg = config_from_args(["--data_parallel", "2", "--nGPU", "4",
                            "--table_shards", "2"])
    assert (cfg.data_parallel, cfg.nGPU, cfg.table_shards) == (2, 4, 2)
    check_supported(cfg, "cpu")
    check_supported(cfg, "cuda")
    with pytest.raises(ValueError, match="float32"):
        check_supported(cfg.replace(param_dtype="bfloat16"))
    with pytest.raises(ValueError, match="no plain route"):
        check_supported(cfg.replace(use_pallas="off"), "cuda")


def test_table_lookup_by_mesh():
    assert table_lookup(None) is common.default_lookup
    assert table_lookup(pmesh.Mesh(2, 1, 0, "cpu")) is common.default_lookup
    assert table_lookup(pmesh.Mesh(1, 2, 0, "cpu")) is not (
        common.default_lookup)
