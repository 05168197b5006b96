"""Convert params between the JAX package's pytree and the port.

Both sides hold a nested dict with the same keys, and the port keeps the
JAX package's layouts: Linear weights stay input-major (in, out), as
``ops.common.linear`` reads them, so no transpose is needed. The JAX side
is handed over as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from newsrecommendation_tpu_torch.utils import resolve_device


def params_from_jax(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def params_to_jax(params):
    """Nested dict of tensors -> nested dict of numpy arrays (host copies),
    ready for ``jax.tree.map(jnp.asarray, ...)``."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
