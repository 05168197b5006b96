"""Batch-in-lanes ("blanes") exp-MHSA over a biased fused [q|k|v]
projection: a CUDA kernel pair behind an autograd Function, and their
plain PyTorch versions.

Replaces, in ``newsrecommendation_tpu/ops/pallas/experimental_blanes.py``:
  - ``_blanes_fwd_call`` (``_blanes_fwd_kernel``): the forward, unmasked
    and key-masked -> ``csrc/blanes.cu``, kernel "blanes_fwd" (row 15);
  - ``_blanes_bwd_call`` (``_blanes_bwd_kernel``): the backward, which
    recomputes the probs and writes the fused dqkv -> ``csrc/blanes.cu``,
    kernel "blanes_bwd" (row 16).
``ops/attention.py`` routes here under ``set_attention_layout("blanes")``
(the Config field ``attention_layout``), as the JAX package's dispatch
does: after the flash check, before the 2-D-I/O one, masked and unmasked.

The function is rows 1 and 4's on qkv with the bias already added (max over
all keys, mask after the exp, the 1e-8 exp(-m) term, a rounded to v's
dtype before a@v, ds to k's before the dq and dk dots, f32 sums), so the
plain versions are rows 1 and 4's with a zero bias. The kernels are their
own (``csrc/blanes.cu``): the TPU kernel puts the batch in the vector lanes;
these give a warp one (row, head, query) at a time with its lanes over the
keys, or past SHORT_T in bf16 16 queries on tensor cores, in two regimes
chosen from T by ``launch_plan``. Past what those layouts hold (heads
wider than MAX_HEAD, or one head's K and V past a block's shared memory;
``regime``) the same entry points run the fused-qkv kernels' templates
(rows 1 and 4, ``csrc/qkv_fwd.cuh`` and ``csrc/qkv_bwd.cuh``; row 1 with a
zero bias, row 4 with none in its resident regime and a zero bias past
it), which compute the same function. The backward always
recomputes, whatever ``bwd_residuals`` says, as the JAX package's custom
VJPs do.

A CPU tensor takes the plain versions, a CUDA tensor launches the kernels
or raises. Builds and launch counts: ``ops/kernels.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels

MAX_HEAD = 64  # widest head the kernels take
SHORT_T = 64  # longest T of the resident regime (csrc/blanes.cu kShortT)
TILE = 64  # query (or key) rows of a work item past SHORT_T
MMA_TILE = 128  # rows of a work item of the bf16 tensor-core kernels
WARPS = 8  # warps of a block
SM_SMEM = 233472  # shared memory of one SM; a block takes 1 KB more
MAX_PER_SM = 8  # blocks of 256 threads an SM holds
KINDS = {"fwd": 0, "bwd": 1, "bwd_query": 2, "bwd_key": 3}


class Plan(NamedTuple):
    """One launch of a blanes kernel: a work item is one batch row,
    ``heads`` heads and ``rows`` query (or key) rows; ``nbuf`` stage
    buffers; ``blocks`` blocks walk the ``items``; ``smem`` bytes each."""
    kind: str
    heads: int
    rows: int
    nbuf: int
    items: int
    blocks: int
    smem: int


def long_mma(t: int, d: int, itemsize: int) -> bool:
    """Whether the long regime takes the tensor-core kernels (csrc/blanes.cu
    ``long_mma``): past SHORT_T, bf16, heads of at most 32."""
    return t > SHORT_T and itemsize == 2 and d <= 32


def _row_bytes(d, ve, heads, width):
    """Bytes of a row of ``heads`` heads of D elements, each padded to
    ``ve`` elements held at ``width`` bytes; the row padded to an odd
    number of 16-byte units (csrc/blanes.cu ``row_bytes``)."""
    rb = heads * -(-d // ve) * ve * width
    return rb + 16 if (rb // 16) % 2 == 0 else rb


def smem_bytes(kind: str, t: int, d: int, itemsize: int, heads: int,
               rows: int, nbuf: int) -> int:
    """Shared bytes of one block (csrc/blanes.cu ``layout_of``): ``nbuf``
    stage buffers of staged rows in the input dtype, then f32 arrays. At
    T <= SHORT_T: a bf16 K (and V, bwd) converted once to f32, and the
    (heads, T, T|1) round(a) (and ds, bwd). Past it: a row per warp and
    query it takes at once (fwd: two where D <= 32; none in the tensor-core
    forward, whose heads are padded to 16 elements), or two per warp
    (bwd_query, bwd_key; none on tensor cores; bwd_key also stages m, den,
    r)."""
    mma = kind != "bwd" and long_mma(t, d, itemsize)
    rb = _row_bytes(d, 16 if mma else 16 // itemsize, heads, itemsize)
    wide = _row_bytes(d, 16 // itemsize, heads, 4) if itemsize == 2 else 0
    warp_rows = WARPS * t * 4
    tt = heads * t * (t | 1) * 4
    short = t <= SHORT_T
    stage, extra = {
        "fwd": ((3 * t * rb, t * wide + tt) if short else
                ((rows + 2 * t) * rb,
                 0 if mma else (2 if d <= 32 else 1) * warp_rows)),
        "bwd": (4 * t * rb, 2 * t * wide + 2 * tt),
        "bwd_query": ((2 * rows + 2 * t) * rb, 0 if mma else 2 * warp_rows),
        "bwd_key": ((2 * t + 2 * rows) * rb + -(-12 * t // 16) * 16,
                    0 if mma else 2 * warp_rows),
    }[kind]
    return nbuf * stage + extra


def launch_plan(kind: str, n: int, t: int, n_heads: int, d: int,
                itemsize: int, sms: int) -> Plan:
    """The launch of kernel ``kind`` at (N, T, H, D): at T <= SHORT_T an
    item is four heads and every row; past it one head and TILE rows
    (MMA_TILE on the bf16 tensor-core kernels). It takes the first of two
    stage buffers (then one) and four heads (then two, one) that leaves
    room for two blocks on an SM, else the first that fits a block. The
    grid is the items, at most as many blocks as the SMs hold (and at
    least two per SM: blocks past what is resident wait their turn).
    Raises NotImplementedError when one buffer does not fit in a block."""
    short = t <= SHORT_T
    tile = MMA_TILE if long_mma(t, d, itemsize) else TILE
    rows = t if short else min(tile, t)
    shapes = ([(min(n_heads, g), nbuf) for nbuf in (2, 1) for g in (4, 2, 1)]
              if short else [(1, 2), (1, 1)])
    fits = []
    for heads, nbuf in shapes:
        smem = smem_bytes(kind, t, d, itemsize, heads, rows, nbuf)
        if smem <= kernels.MAX_SMEM:
            fits.append((min(MAX_PER_SM, SM_SMEM // (smem + 1024)), heads,
                         nbuf, smem))
    if not fits:
        raise NotImplementedError(
            f"T={t}, D={d}: the blanes {kind} kernel needs more than "
            f"{kernels.MAX_SMEM} bytes of shared memory per block")
    per_sm, heads, nbuf, smem = next((f for f in fits if f[0] >= 2), fits[0])
    items = n * -(-n_heads // heads) * -(-t // rows)
    return Plan(kind, heads, rows, nbuf, items,
                min(items, sms * max(per_sm, 2)), smem)


def regime(t: int, d: int, itemsize: int) -> str:
    """"blanes" where rows 15-16's own kernels take (T, D) in the dtype:
    heads of up to MAX_HEAD whose every kernel fits a block with one head
    and one buffer; else "qkv", the fused-qkv kernels' templates (any T
    and D)."""
    if d > MAX_HEAD:
        return "qkv"
    short = t <= SHORT_T
    kinds = ["fwd", "bwd"] if short else ["fwd", "bwd_query", "bwd_key"]
    tile = MMA_TILE if long_mma(t, d, itemsize) else TILE
    rows = t if short else min(tile, t)
    fits = all(smem_bytes(k, t, d, itemsize, 1, rows, 1) <= kernels.MAX_SMEM
               for k in kinds)
    return "blanes" if fits else "qkv"


def launch_plans(n: int, t: int, n_heads: int, d: int, itemsize: int,
                 sms: int) -> dict:
    """{"fwd": Plan, "bwd": [Plan, ...]}: the backward is one kernel at
    T <= SHORT_T, else its query side then its key side."""
    bwd = ["bwd"] if t <= SHORT_T else ["bwd_query", "bwd_key"]
    return {"fwd": launch_plan("fwd", n, t, n_heads, d, itemsize, sms),
            "bwd": [launch_plan(k, n, t, n_heads, d, itemsize, sms)
                    for k in bwd]}


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(qkv, key_mask, n_heads):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)}")
    n, t, w3 = qkv.shape
    if n_heads < 1 or w3 % (3 * n_heads) != 0:
        raise ValueError(f"qkv width {w3} is not 3 * n_heads({n_heads}) * D")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, w3 // (3 * n_heads)


def blanes_fwd_reference(qkv, key_mask, n_heads: int):
    """Plain PyTorch version of row 15: the context (N, T, HD) in qkv's
    dtype from the biased qkv and the key mask (N, T) f32 or None."""
    _check(qkv, key_mask, n_heads)
    return fa.exp_mhsa_qkv_bias_reference(qkv, qkv.new_zeros(qkv.shape[-1]),
                                          key_mask, n_heads)


def blanes_bwd_reference(qkv, key_mask, g, n_heads: int):
    """Plain PyTorch version of row 16: dqkv (N, T, 3HD) in qkv's dtype
    from the biased qkv, the key mask or None and the context's gradient g
    (N, T, HD) in qkv's dtype, the probs recomputed."""
    _check(qkv, key_mask, n_heads)
    return fa.qkv_bwd_reference(qkv, qkv.new_zeros(qkv.shape[-1]), key_mask,
                                g, n_heads)


def _check_launch(qkv, key_mask, *more):
    kernels.check_operands(qkv, key_mask, *more)
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")


def blanes_fwd(qkv, key_mask, n_heads: int):
    """Kernel row 15 on CUDA tensors, with the plain version's contract.
    Raises for other devices."""
    n, t, d = _check(qkv, key_mask, n_heads)
    _check_launch(qkv, key_mask)
    variant = "blanes" if key_mask is None else "blanes_masked"
    if regime(t, d, qkv.element_size()) == "qkv":
        # row 1's launch with a zero bias, in its plan's regime, counted as
        # row 15
        return fa._launch(variant, qkv, qkv.new_zeros(qkv.shape[-1]),
                          key_mask, n_heads)
    p = launch_plan("fwd", n, t, n_heads, d, qkv.element_size(),
                    _sms(qkv.device))
    out = torch.empty((n, t, n_heads * d), dtype=qkv.dtype,
                      device=qkv.device)
    kernels.call(variant, kernels.entry("blanes", "blanes_fwd", qkv.dtype),
                 qkv.device, qkv.data_ptr(), kernels.ptr(key_mask),
                 out.data_ptr(), n, t, n_heads, d, p.heads, p.rows, p.nbuf,
                 p.blocks)
    return out


def blanes_bwd(qkv, key_mask, g, n_heads: int):
    """Kernel row 16 on CUDA tensors, with the plain version's contract.
    Raises for other devices."""
    n, t, d = _check(qkv, key_mask, n_heads)
    if g.shape != (n, t, n_heads * d) or g.dtype != qkv.dtype:
        raise ValueError(f"g must be {qkv.dtype} ({n}, {t}, {n_heads * d}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _check_launch(qkv, key_mask, g)
    variant = "blanes_bwd" if key_mask is None else "blanes_bwd_masked"
    if regime(t, d, qkv.element_size()) == "qkv":
        # row 4's kernels on qkv as it is (no bias; a zero bias past the
        # resident regime), counted as row 16
        dqkv = torch.empty_like(qkv)
        fa._bwd_call(variant, "qkv_bwd", "qkv_bwd", qkv, None, key_mask, g,
                     dqkv, n, t, n_heads, d)
        return dqkv
    plans = launch_plans(n, t, n_heads, d, qkv.element_size(),
                         _sms(qkv.device))["bwd"]
    dqkv = torch.empty_like(qkv)
    # past SHORT_T: each (row, head, query)'s m, den and r, from the query
    # side to the key side
    stats = (torch.empty((3 * n * n_heads * t,), dtype=torch.float32,
                         device=qkv.device) if len(plans) == 2 else None)
    key = plans[-1] if len(plans) == 2 else Plan("", 0, 0, 0, 0, 0, 0)
    kernels.call(variant, kernels.entry("blanes", "blanes_bwd", qkv.dtype),
                 qkv.device, qkv.data_ptr(), kernels.ptr(key_mask),
                 g.data_ptr(),
                 dqkv.data_ptr(), kernels.ptr(stats), n, t, n_heads, d,
                 plans[0].heads, plans[0].rows, plans[0].nbuf,
                 plans[0].blocks, key.rows, key.nbuf, key.blocks)
    return dqkv


class _ExpMhsaQkvBlanes(torch.autograd.Function):
    """Row 15 forward (saves qkv and the mask), row 16 backward; their plain
    versions for CPU tensors. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, key_mask, n_heads):
        ctx.n_heads = n_heads
        ctx.save_for_backward(qkv, key_mask)
        fwd = blanes_fwd_reference if qkv.device.type == "cpu" else blanes_fwd
        return fwd(qkv, key_mask, n_heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, key_mask = ctx.saved_tensors
        # the gradient arrives in any layout and float type: the kernel
        # takes it contiguous in qkv's dtype
        g = g.to(qkv.dtype).contiguous()
        bwd = blanes_bwd_reference if qkv.device.type == "cpu" else blanes_bwd
        return bwd(qkv, key_mask, g, ctx.n_heads), None, None


def _attend(qkv, key_mask, n_heads):
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _ExpMhsaQkvBlanes.apply(qkv, key_mask, n_heads)
    if qkv.device.type == "cpu":
        return blanes_fwd_reference(qkv, key_mask, n_heads)
    return blanes_fwd(qkv, key_mask, n_heads)


def exp_mhsa_qkv_blanes(qkv, n_heads: int):
    """Exp-MHSA over a biased fused projection (N, T, 3HD), batch-in-lanes
    kernels. Returns the context (N, T, HD), differentiable in qkv."""
    return _attend(qkv, None, n_heads)


def exp_mhsa_qkv_blanes_masked(qkv, key_mask, n_heads: int):
    """Key-masked exp_mhsa_qkv_blanes; key_mask (N, T) float32 0/1 over
    keys. A row whose keys are all masked gives 0."""
    return _attend(qkv, key_mask, n_heads)
