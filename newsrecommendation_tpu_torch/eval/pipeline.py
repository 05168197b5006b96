"""Phase 1 of evaluation and serving: the whole-corpus news-vector cache.

The news encoder runs over the combined feature matrix in chunks of
cfg.eval_news_chunk rows; the (num_news+1, news_dim) cache stays on the
device. Phase 2 (impression metrics) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.inference_mode()
def compute_news_scoring(model, params, cfg,
                         news_features: np.ndarray) -> torch.Tensor:
    """Encode the whole corpus -> (num_news+1, news_dim) cache on the
    params' device.

    The feature matrix crosses to the device once; each chunk is a slice of
    it. Row 0 is the unknown-news vector: the reference computes it from
    the zero feature row (not forced to zero), so it is kept as encoded.
    """
    device = params["embedding_table"].device
    feats = torch.from_numpy(np.ascontiguousarray(news_features)).to(device)
    n = feats.shape[0]
    chunk = max(min(cfg.eval_news_chunk, n), 1)
    outs = [model.news_encoder(params, cfg, feats[start:start + chunk])
            for start in range(0, n, chunk)]
    return torch.cat(outs, dim=0)
