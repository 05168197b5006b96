"""One bf16 train step of the port against the JAX package's, on the CPU:
the headline step's activation dtype (bf16 activations over f32 params),
with dropout off and the word table frozen, for user_log_mask False and
True.

The JAX kernels run in Pallas interpret mode with the fused encoder-tail
kernel off (interpret mode alone turns it on); the port takes the plain
versions of its kernels, which keep the kernels' bf16 rounding points. The
loss is held to rtol 1e-5. Each leaf's gradient is held to within 5e-2 of
the step's largest gradient: bf16 rounds the attention probabilities, the
ds products and every activation, and two frameworks sum in other orders,
so the f32 step's 2e-4 per leaf does not apply. The four leaves whose
gradient is 0 analytically (tests/test_torch_train_step.py,
ZERO_GRAD_LEAVES) are held to the same bound; in bf16 what is left of them
is rounding of the rounded ds, not f32 noise, so the f32 test's 1e-6 does
not apply either.
"""

import jax
import numpy as np
import pytest
import torch

from newsrecommendation_tpu.models import get_model as jax_get_model
from newsrecommendation_tpu.ops.pallas import set_fused_tail, set_pallas_mode
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.train import create_train_state, make_train_step
from tests.test_torch_train_step import (
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

GRAD_SHARE = 5e-2


@pytest.fixture
def jax_kernels():
    set_pallas_mode("interpret")
    set_fused_tail("off")
    try:
        yield
    finally:
        set_pallas_mode("auto")
        set_fused_tail("auto")


@pytest.mark.parametrize("user_log_mask", [False, True])
def test_bf16_step_matches_jax(tiny_cfg, jax_kernels, user_log_mask):
    jcfg = tiny_cfg.replace(compute_dtype="bfloat16", deterministic=True,
                            lr=3e-4, donate_state=False,
                            user_log_mask=user_log_mask,
                            freeze_embedding=True)
    cfg = port_cfg(jcfg)
    jparams = make_params(jcfg)
    batch = make_batch(cfg, seed=1)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_get_model("NRMS").forward(
        p, jcfg, j_batch(batch), deterministic=True)[0])(jparams)
    state = create_train_state(cfg, to_port(jparams))
    state, metrics = make_train_step(cfg, get_model("NRMS"))(
        state, t_batch(batch), 0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)
    pairs = {}
    for path, p in leaves(state.params):
        if path == ("embedding_table",):
            assert p.grad is None  # frozen
            continue
        jg = np.asarray(get(jgrads, path), np.float32)
        g = np.zeros_like(jg) if p.grad is None else p.grad.numpy()
        pairs[path] = (g, jg)
    largest = max(np.abs(jg).max() for _, jg in pairs.values())
    assert largest > 0
    for path, (g, jg) in pairs.items():
        err = np.abs(g - jg).max()
        assert err <= GRAD_SHARE * largest, (path, err, largest)
    assert ZERO_GRAD_LEAVES <= set(pairs)
