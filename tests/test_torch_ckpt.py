"""The port's checkpoints (ckpt/checkpoint.py, fit's saves) and the train
state bridge on the CPU, against the JAX package's: round trip, the frozen
table left out and rebuilt, resume continuity with dropout on, naming and
ordering, atomic writes, the background saver's snapshot, the sidecar,
and a JAX train state carried into the port with its Adam moments."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from newsrecommendation_tpu.ckpt import latest_checkpoint as jax_latest
from newsrecommendation_tpu.ckpt import save_checkpoint as jax_save
from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.train import create_train_state as jax_state
from newsrecommendation_tpu.train.step import make_train_step as jax_step
from newsrecommendation_tpu_torch.bridge import state_from_jax, state_to_jax
from newsrecommendation_tpu_torch.ckpt import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from newsrecommendation_tpu_torch.data.loader import TrainSamples
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.train import (
    create_train_state,
    fit,
    make_train_step,
)
from newsrecommendation_tpu_torch.train.loop import _AsyncSaver
from tests.test_torch_train_loop import tiny_samples
from tests.test_torch_cli import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import (
    STEP_TOL,
    ZERO_GRAD_LEAVES,
    get,
    j_batch,
    leaves,
    make_batch,
    make_params,
    port_cfg,
    t_batch,
    to_port,
)


def trained_state(cfg, seed=0, steps=2):
    """A port state after ``steps`` Adam steps (so the optimizer holds
    moments), dropout as cfg says."""
    state = create_train_state(cfg, to_port(make_params(cfg, seed)))
    step = make_train_step(cfg, get_model("NRMS"))
    for i in range(steps):
        state, _ = step(state, t_batch(make_batch(cfg, 10 + i)), cfg.seed)
    return state


def fresh_state(cfg, seed=99, vocab=None):
    params = to_port(make_params(cfg, seed))
    if vocab is not None:  # a table of another shape (another corpus)
        rng = np.random.default_rng(seed)
        params["embedding_table"] = torch.from_numpy(rng.normal(
            size=(vocab, cfg.word_embedding_dim)).astype(np.float32))
    return create_train_state(cfg, params)


def assert_states_equal(a, b):
    assert a.step == b.step
    for (path, x), (_, y) in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y), path
        sa, sb = a.optimizer.state.get(x), b.optimizer.state.get(y)
        assert bool(sa) == bool(sb), path
        for key in sa or ():
            assert torch.equal(sa[key], sb[key]), (path, key)


@pytest.mark.parametrize("freeze", [True, False])
def test_roundtrip(tiny_cfg, tmp_path, freeze):
    cfg = port_cfg(tiny_cfg, freeze_embedding=freeze, drop_rate=0.2)
    state = trained_state(cfg)
    save_checkpoint(str(tmp_path), "epoch-1.ckpt", state, cfg,
                    category_dict={"a": 1}, word_dict={"w": 1})
    template = fresh_state(cfg)
    if freeze:  # the frozen table comes from the template, as built
        template.params["embedding_table"].copy_(
            state.params["embedding_table"])
    restored, sidecar = load_checkpoint(str(tmp_path / "epoch-1.ckpt"),
                                        template, cfg)
    assert restored.step == state.step == 2
    assert_states_equal(restored, state)
    assert sidecar["category_dict"] == {"a": 1}
    assert sidecar["word_dict"] == {"w": 1}
    # the restored optimizer steps the restored leaves, at the run's lr
    assert restored.optimizer.param_groups[0]["lr"] == cfg.lr
    params = {id(p) for _, p in leaves(restored.params)}
    assert all(id(p) in params
               for p in restored.optimizer.param_groups[0]["params"])


def test_load_keeps_the_runs_lr(tiny_cfg, tmp_path):
    """A resumed run with another --lr trains at it (optax's lr is no part
    of the saved state either)."""
    cfg = port_cfg(tiny_cfg)
    save_checkpoint(str(tmp_path), "epoch-1.ckpt", trained_state(cfg), cfg)
    other = cfg.replace(lr=cfg.lr * 3)
    restored, _ = load_checkpoint(str(tmp_path / "epoch-1.ckpt"),
                                  fresh_state(other), other)
    assert restored.optimizer.param_groups[0]["lr"] == other.lr


def test_frozen_table_excluded_and_rebuilt(tiny_cfg, tmp_path):
    """A frozen table is not written, and load takes the template's, even
    one of another shape (the test corpus's)."""
    cfg = port_cfg(tiny_cfg, freeze_embedding=True)
    state = trained_state(cfg)
    path = save_checkpoint(str(tmp_path), "epoch-1.ckpt", state, cfg)
    unfrozen = cfg.replace(freeze_embedding=False)
    path_uf = save_checkpoint(str(tmp_path), "unfrozen.ckpt",
                              trained_state(unfrozen), unfrozen)
    assert os.path.getsize(path) < os.path.getsize(path_uf)
    blob = torch.load(path, weights_only=True)
    assert blob["frozen_table_excluded"] is True
    assert blob["params"]["embedding_table"].shape == ()
    fresh = fresh_state(cfg, vocab=50)
    fresh_table = fresh.params["embedding_table"].clone()
    restored, _ = load_checkpoint(path, fresh, cfg)
    assert torch.equal(restored.params["embedding_table"], fresh_table)
    for path_, x in leaves(state.params["news_encoder"]):
        assert torch.equal(get(restored.params["news_encoder"], path_), x)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path_uf, fresh_state(unfrozen, vocab=50), unfrozen)


def _fit(cfg, arrays, feats, **kw):
    state = create_train_state(cfg, to_port(make_params(cfg)))
    return fit(cfg, get_model("NRMS"), state, TrainSamples(**arrays), feats,
               **kw)


def test_resume_training_continuity(tiny_cfg, tmp_path):
    """Two epochs straight, dropout on, equal bit for bit to one epoch,
    a checkpoint, a load into a fresh state and one more epoch from
    start_epoch 1: the step (which seeds the dropout draws), the params
    and the Adam moments all carry over."""
    cfg = port_cfg(tiny_cfg, epochs=2, log_steps=3, drop_rate=0.2, lr=3e-3)
    arrays, feats = tiny_samples(cfg, n=3 * cfg.batch_size + 1)
    straight, _ = _fit(cfg, arrays, feats)
    _fit(cfg.replace(epochs=1), arrays, feats, save_dir=str(tmp_path))
    resumed, _ = load_checkpoint(str(tmp_path / "epoch-1.ckpt"),
                                 fresh_state(cfg), cfg)
    assert resumed.step == 4
    resumed, _ = fit(cfg.replace(start_epoch=1), get_model("NRMS"), resumed,
                     TrainSamples(**arrays), feats)
    assert_states_equal(resumed, straight)


def test_latest_checkpoint_ordering(tmp_path):
    for name in ("epoch-1.ckpt", "epoch-2-500.ckpt", "epoch-2.ckpt",
                 "epoch-10-100.ckpt", "epoch-3.ckpt.json", "other.ckpt"):
        (tmp_path / name).write_bytes(b"x")
    assert latest_checkpoint(str(tmp_path)).endswith("epoch-10-100.ckpt")
    assert latest_checkpoint(str(tmp_path)) == jax_latest(str(tmp_path))
    (tmp_path / "epoch-10-100.ckpt").unlink()
    # a mid-epoch save ranks above its epoch's end, as in JAX
    assert latest_checkpoint(str(tmp_path)).endswith("epoch-2-500.ckpt")
    assert latest_checkpoint(str(tmp_path)) == jax_latest(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_atomic_write_no_tmp_left(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg)
    save_checkpoint(str(tmp_path), "epoch-1.ckpt", trained_state(cfg), cfg)
    assert sorted(os.listdir(tmp_path)) == ["epoch-1.ckpt",
                                            "epoch-1.ckpt.json"]


def test_async_saves_hold_the_state_at_save_time(tiny_cfg, tmp_path):
    """fit's background writer captures each state at its save point while
    the steps go on updating the live tensors in place: epoch-1.ckpt is
    the state one epoch in (as a separate one-epoch run ends), epoch-2.ckpt
    the state fit returns, and the mid-epoch saves come in between."""
    cfg = port_cfg(tiny_cfg, epochs=2, log_steps=2, save_steps=2,
                   drop_rate=0.2)
    arrays, feats = tiny_samples(cfg, n=5 * cfg.batch_size)
    final, _ = _fit(cfg, arrays, feats, save_dir=str(tmp_path))
    one_epoch, _ = _fit(cfg.replace(epochs=1), arrays, feats)
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt"))
    assert names == ["epoch-1-2.ckpt", "epoch-1-4.ckpt", "epoch-1.ckpt",
                     "epoch-2-2.ckpt", "epoch-2-4.ckpt", "epoch-2.ckpt"]

    def load(name):
        return load_checkpoint(str(tmp_path / name), fresh_state(cfg),
                               cfg)[0]

    assert_states_equal(load("epoch-1.ckpt"), one_epoch)
    assert_states_equal(load("epoch-2.ckpt"), final)
    steps = [load(n).step for n in ("epoch-1-2.ckpt", "epoch-1-4.ckpt",
                                    "epoch-2-2.ckpt", "epoch-2-4.ckpt")]
    assert steps == [3, 5, 8, 10] and final.step == 10
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [x["kind"] for x in lines] == ["train"] * 6 + ["train_summary"]
    assert [(x["epoch"], x["step"]) for x in lines[:6]] == [
        (0, 0), (0, 2), (0, 4), (1, 0), (1, 2), (1, 4)]


def test_async_saver_raises_a_failed_write(tiny_cfg, tmp_path):
    cfg = port_cfg(tiny_cfg)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = _AsyncSaver()
    saver.save(str(blocker / "sub"), "epoch-1.ckpt", trained_state(cfg), cfg)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        saver.wait()
    saver.wait()  # raised once


def test_sidecar_equals_jax(tiny_cfg, tmp_path):
    """The same config and vocabs give the JAX package's sidecar, key for
    key (the port's Config has every JAX field)."""
    vocabs = dict(category_dict={"news": 1, "sports": 2},
                  subcategory_dict={"a": 1}, word_dict={"w": 1, "v": 2})
    jcfg = tiny_cfg.replace(freeze_embedding=True)
    cfg = port_cfg(jcfg)
    jax_save(str(tmp_path / "jax"), "epoch-1.ckpt",
             jax_state(jcfg, make_params(jcfg)), jcfg, **vocabs)
    save_checkpoint(str(tmp_path / "port"), "epoch-1.ckpt",
                    trained_state(cfg, steps=0), cfg, **vocabs)
    want = json.loads((tmp_path / "jax" / "epoch-1.ckpt.json").read_text())
    got = json.loads((tmp_path / "port" / "epoch-1.ckpt.json").read_text())
    assert got == want and got["config"]["freeze_embedding"] is True


@pytest.mark.parametrize("freeze", [True, False])
def test_state_from_jax_continues_a_jax_run(tiny_cfg, freeze):
    """Two JAX Adam steps, the state carried into the port (params, mu,
    nu, count), then one port step against JAX's third, leaf by leaf at
    the train-step tolerances; and back to JAX unchanged."""
    jcfg = tiny_cfg.replace(deterministic=True, lr=3e-4, donate_state=False,
                            freeze_embedding=freeze)
    cfg = port_cfg(jcfg)
    jst = jax_state(jcfg, make_params(jcfg))
    jstep = jax_step(jcfg, jax_get_model("NRMS"))
    key = jax.random.PRNGKey(0)
    for seed in (1, 2):
        jst, _ = jstep(jst, j_batch(make_batch(cfg, seed)), key)
    state = state_from_jax(jax.tree.map(np.asarray, jst.params),
                           jst.opt_state, cfg, device="cpu")
    assert state.step == 2
    step, params, opt = state_to_jax(state, cfg)
    back = serialization.from_state_dict(jst.opt_state, opt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the state dict form goes in as well as optax's own state
    again = state_from_jax(params, serialization.to_state_dict(jst.opt_state),
                           cfg, device="cpu")
    assert_states_equal(again, state)

    batch = make_batch(cfg, 3)
    jst, _ = jstep(jst, j_batch(batch), key)
    state, _ = make_train_step(cfg, get_model("NRMS"))(state, t_batch(batch),
                                                       0)
    assert state.step == int(jst.step) == 3
    for path, p in leaves(state.params):
        got, want = p.detach().numpy(), np.asarray(get(jst.params, path))
        if path in ZERO_GRAD_LEAVES:
            assert np.abs(got - want).max() < 4 * cfg.lr, path
            continue
        np.testing.assert_allclose(got, want, **STEP_TOL, err_msg=str(path))
