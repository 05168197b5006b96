"""Row-sharded embedding tables with a collective lookup.

The reference replicates its frozen (num_news+1, T*word_dim) title table
on every GPU (NAML.py:105-107), about 3 GB at MIND-large scale: the
memory wall the JAX package row-shards its way past
(newsrecommendation_tpu/parallel/sharded_embedding.py). Here a table's
rows are split over the mesh's table index: rank t of a table group holds
rows [t*r, (t+1)*r) of the zero-padded table, r = rows per shard.

A lookup gathers the requested rows the rank owns (a masked local take of
the shifted ids), then one all-reduce (SUM) over the table group puts the
full rows on every rank of it. Its backward is the masked scatter-add of
the output's gradient into the local rows, with no collective: every rank
of a table group sees the same batch and so computes the same output
gradient, and a collective there would count a row's gradient ts times.

Row 0 of the global table is the all-zero unknown-news row; the model's
lookup wrapper masks by (id != 0), not this module.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def padded_rows(num_rows: int, num_shards: int) -> int:
    """Global row count padded so every shard holds the same number."""
    return -(-num_rows // num_shards) * num_shards


def shard_table(table: np.ndarray, num_shards: int) -> np.ndarray:
    """A (N, D) table zero-padded to a shard-divisible row count."""
    n, d = table.shape
    total = padded_rows(n, num_shards)
    if total == n:
        return table
    out = np.zeros((total, d), dtype=table.dtype)
    out[:n] = table
    return out


def local_rows(table, num_shards: int, index: int):
    """Shard ``index`` of ``num_shards`` of a table (numpy or torch): its
    rows of the zero-padded table."""
    r = padded_rows(table.shape[0], num_shards) // num_shards
    start, stop = index * r, (index + 1) * r
    part = table[start:min(stop, table.shape[0])]
    if part.shape[0] == r:
        return part
    if isinstance(table, np.ndarray):
        pad = np.zeros((r - part.shape[0],) + table.shape[1:], table.dtype)
        return np.concatenate([part, pad])
    pad = table.new_zeros((r - part.shape[0],) + tuple(table.shape[1:]))
    return torch.cat([part, pad])


def _local_index(ids, rows_per_shard, offset):
    local = ids.long() - offset
    valid = (local >= 0) & (local < rows_per_shard)
    return local.clamp(0, rows_per_shard - 1), valid


def masked_local_take(local_table, ids, offset: int):
    """The rows of ``ids`` (global row indices) that the local shard,
    holding rows [offset, offset + len), owns; zeros elsewhere."""
    clipped, valid = _local_index(ids, local_table.shape[0], offset)
    return local_table[clipped] * valid[..., None].to(local_table.dtype)


def masked_local_scatter(grad_rows, ids, rows_per_shard: int, offset: int,
                         dtype):
    """The backward of masked_local_take: the gradient of each gathered
    row added into the local row it came from, summed in f32."""
    clipped, valid = _local_index(ids, rows_per_shard, offset)
    d = grad_rows.shape[-1]
    g = (grad_rows.float() * valid[..., None]).reshape(-1, d)
    out = torch.zeros((rows_per_shard, d), dtype=torch.float32,
                      device=grad_rows.device)
    out.index_add_(0, clipped.reshape(-1), g)
    return out.to(dtype)


class _GatherRowsSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local_table, ids, offset, group):
        rows = masked_local_take(local_table, ids, offset)
        ctx.save_for_backward(ids)
        ctx.meta = (local_table.shape[0], offset, local_table.dtype)
        rows = rows.contiguous()
        dist.all_reduce(rows, group=group)  # gloo takes bf16 too, CUDA's
        return rows

    @staticmethod
    def backward(ctx, grad_rows):
        (ids,) = ctx.saved_tensors
        rows_per_shard, offset, dtype = ctx.meta
        grad = None
        if ctx.needs_input_grad[0]:
            grad = masked_local_scatter(grad_rows, ids, rows_per_shard,
                                        offset, dtype)
        return grad, None, None, None


def gather_rows_sharded(local_table: torch.Tensor, ids: torch.Tensor,
                        mesh) -> torch.Tensor:
    """Full rows (*ids.shape, D) of a row-sharded table on every rank of
    the mesh's table group. local_table: this rank's (r, D) shard; ids:
    global row indices, equal on every rank of the group."""
    offset = mesh.table_index * local_table.shape[0]
    return _GatherRowsSharded.apply(local_table, ids, offset,
                                    mesh.table_group)
