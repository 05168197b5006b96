"""The fused NRMS encoder tail: exp-MHSA -> dropout -> additive attention
pooling in one kernel per direction, and their plain PyTorch versions.

Replaces, in
``newsrecommendation_tpu/ops/pallas/experimental_fused_encoder.py``:
  - ``_fwd_call`` (``_fwd_kernel``, ``_masked_fwd_kernel``): the forward ->
    ``csrc/fused_tail_fwd.cu``, kernel "fused_tail_fwd" (row 13);
  - ``_bwd_call`` (``_bwd_kernel``, ``_masked_bwd_kernel``): the backward,
    which recomputes the whole tail from qkv and returns dqkv and the
    pooling parameters' gradients summed over every row ->
    ``csrc/fused_tail_bwd.cu``, kernel "fused_tail_bwd" (row 14).
In the forward the (N, T, HD) context never leaves the kernel, and nothing
is saved between the passes: the dropout keep mask is a stateless hash of
each element's global index and a seed read from a device tensor
(``keep_mask``), so the backward draws the same mask and the JAX package's
mask bit for bit. The backward writes the f32 context and d_z once to
scratch for its dw1 product over all positions (``csrc/fused_tail_bwd.cu``).
Three regimes (``tail_launch_plan``): at T <= 64 with heads of up to 64
"resident", items of batch rows on row 15's resident attention, fc1 in k
order on CUDA cores, the bf16 d_z w1^T product on tensor cores and row
16's resident kernel for the bf16 attention backward; past it "tiled"
while its blocks fit (T up to 1024 at the NRMS width): a row's work
spread over blocks of (row, head) for the attention and of 40 positions
for the pooling, one launch per phase, the f32 context and the rows'
vectors in a scratch the wrappers allocate; past that, and for heads
wider than 64, "global": the per-row kernels, one block a row with its
working set in a global scratch of one slot per block
(``csrc/fused_tail.cuh``), and past T = 6456 (5771 in the backward) its
row buffers too: the tail takes any history length, as the JAX
package's does. Every regime keeps the per-row kernels' sums, so the
tiled regime gives their bits.

The rounding points are the TPU kernels': qkv arrives biased in the input
dtype; per-head contexts are concatenated in f32, unrounded; dropout
multiplies the f32 context by keep * 1/(1 - rate); ctx is rounded to w1's
dtype for the fc1 product and e to w2's for the fc2 product, both summed
in f32 with b1 and b2 added in f32; alpha is the exp-normalise over the
key mask with the 1e-8 * exp(-max) term and weighs the f32 context; the
output is rounded to qkv's dtype. The backward takes g in qkv's dtype,
contracts dw1 from the f32 context, rounds d_z to w1's dtype for the
d_z w1^T product, multiplies d_ctx by the keep mask and rounds it to qkv's
dtype, then runs the attention backward with the probs recomputed (row
16's resident kernel, or row 4's). In bf16 the resident regime's d_z w1^T
sums in the tensor core's order. One departure: db2, the sum of
d_a, is r (1 - sum(alpha)) per row, 0 but for the normalisation's 1e-8
term; the TPU kernel's f32 sum of d_a leaves rounding noise in it, where
the port takes the exact expression.

``exp_mhsa_pool`` and ``exp_mhsa_pool_masked`` are the autograd entry
points, with the JAX package's signatures (less ``block_rows``). A CPU
tensor takes the plain versions, a CUDA tensor launches the kernels or
raises. Builds and launch counts: ``ops/kernels.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import blockwise
from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
from newsrecommendation_tpu_torch.ops import fused_attention as fa
from newsrecommendation_tpu_torch.ops import kernels
from newsrecommendation_tpu_torch.ops.attention import masked_exp_normalize

_M32 = 0xFFFFFFFF
_SEED_MUL = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): two products of at
    most 48 bits, so nothing overflows an int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def drop_threshold(drop_rate: float) -> int:
    """The uint32 below which a hashed element is dropped."""
    return min(int(round(drop_rate * 2.0 ** 32)), 2 ** 32 - 1)


def keep_mask(shape, drop_rate: float, seed, row0: int = 0):
    """The dropout keep/scale mask of a (bn, T, HD) block whose first row is
    global row ``row0``: keep(x >= threshold) * 1/(1 - drop_rate), f32, from
    the SplitMix32-style hash of the JAX package's ``_keep_mask`` over each
    element's global flat index ((row0 + i) * T + t) * HD + c plus
    seed * 0x9E3779B9, in uint32 arithmetic (int64 masked to 32 bits).
    ``seed`` is a (1,) int32 tensor; the mask lies on its device."""
    bn, t, hd = shape
    s = seed.reshape(()).to(torch.int64) & _M32
    x = torch.arange(bn * t * hd, dtype=torch.int64, device=seed.device)
    x = (x + row0 * t * hd + _mul32(s, _SEED_MUL)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    keep = (x >= drop_threshold(drop_rate)).float()
    return (keep * (1.0 / (1.0 - drop_rate))).reshape(bn, t, hd)


def _dropout_on(drop_rate: float, deterministic: bool) -> bool:
    return not deterministic and drop_rate > 0.0


def _check(qkv, key_mask, w1, b1, w2, b2, seed, n_heads):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)}")
    n, t, w3 = qkv.shape
    if n_heads < 1 or w3 % (3 * n_heads) != 0:
        raise ValueError(f"qkv width {w3} is not 3 * n_heads({n_heads}) * D")
    hd = w3 // 3
    if w1.dim() != 2 or w1.shape[0] != hd:
        raise ValueError(f"w1 must be ({hd}, Q), got {tuple(w1.shape)}")
    q = w1.shape[1]
    for name, x, shape in (("b1", b1, (1, q)), ("w2", w2, (q, 1)),
                           ("b2", b2, (1, 1)), ("seed", seed, (1,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, hd // n_heads, q


# ---- plain versions -------------------------------------------------------


def _context(qkv, key_mask, n_heads, drop_rate, deterministic, seed):
    """The f32 context after dropout, and the attention probs (N, T, H*T)."""
    ctx, probs = fa.attend_f32(qkv, qkv.new_zeros(qkv.shape[-1]), key_mask,
                               n_heads)
    if _dropout_on(drop_rate, deterministic):
        ctx = ctx * keep_mask(ctx.shape, drop_rate, seed)
    return ctx, probs


def _pool_fwd(ctx, key_mask, w1, b1, w2, b2):
    """Additive attention pooling of the f32 ctx: (out f32, e, alpha, its
    scores)."""
    z = torch.matmul(ctx.to(w1.dtype).float(), w1.float()) + b1[0]
    e = torch.tanh(z)
    a = torch.matmul(e.to(w2.dtype).float(), w2.float())[..., 0] + b2[0, 0]
    alpha = masked_exp_normalize(a, key_mask, dim=-1)
    return torch.einsum("nt,ntc->nc", alpha, ctx), e, alpha, a


def _alpha_rest(a, key_mask):
    """1 - sum(alpha) per row as the exact expression gives it,
    1e-8 exp(-m) / den (0 on a fully masked row)."""
    m = a.amax(-1)
    num = torch.exp(a - m[:, None])
    if key_mask is not None:
        num = num * key_mask
    tail = 1e-8 * torch.exp(-m)
    den = num.sum(-1) + tail
    return torch.where(den > 0, tail / den, torch.zeros_like(den))


def _dw1(ctx, d_z):
    """dw1 = sum over rows and positions of ctx^T d_z, from the f32 ctx."""
    return torch.einsum("ntc,ntq->cq", ctx, d_z)


def _dctx_of_dz(d_z, w1):
    """d_z w1^T with d_z rounded to w1's dtype, summed in f32."""
    return torch.matmul(d_z.to(w1.dtype).float(), w1.float().t())


def fused_tail_fwd_reference(qkv, key_mask, w1, b1, w2, b2, seed,
                             n_heads: int, drop_rate: float,
                             deterministic: bool):
    """Plain PyTorch version of row 13: the pooled (N, HD) in qkv's dtype
    from the biased qkv (N, T, 3HD), the key mask (N, T) f32 or None, the
    pooling params w1 (HD, Q), b1 (1, Q) f32, w2 (Q, 1), b2 (1, 1) f32 and
    the dropout seed (1,) int32."""
    _check(qkv, key_mask, w1, b1, w2, b2, seed, n_heads)
    ctx, _ = _context(qkv, key_mask, n_heads, drop_rate, deterministic, seed)
    return _pool_fwd(ctx, key_mask, w1, b1, w2, b2)[0].to(qkv.dtype)


def fused_tail_bwd_reference(qkv, key_mask, w1, b1, w2, b2, seed, g,
                             n_heads: int, drop_rate: float,
                             deterministic: bool):
    """Plain PyTorch version of row 14: the tail recomputed from qkv, then
    (dqkv in qkv's dtype, dw1 (HD, Q), db1 (1, Q), dw2 (Q, 1), db2 (1, 1)),
    the four summed over every row and position in f32. g (N, HD) is in
    qkv's dtype."""
    _check(qkv, key_mask, w1, b1, w2, b2, seed, n_heads)
    ctx, probs = _context(qkv, key_mask, n_heads, drop_rate, deterministic,
                          seed)
    _, e, alpha, a = _pool_fwd(ctx, key_mask, w1, b1, w2, b2)
    g = g.float()
    # out = sum_t alpha_t ctx_t
    d_alpha = torch.einsum("ntc,nc->nt", ctx, g)
    d_ctx = alpha[:, :, None] * g[:, None, :]
    # the exp-normalise (its max carries no gradient; alpha carries the mask)
    r = (d_alpha * alpha).sum(-1)
    d_a = (d_alpha - r[:, None]) * alpha
    # a = e w2 + b2, e = tanh(z), z = ctx w1 + b1; db2 = sum(d_a) is
    # r (1 - sum(alpha)) per row, 0 but for the 1e-8 term: taken from that
    # expression, where the f32 sum of d_a would leave rounding noise
    dw2 = (e * d_a[:, :, None]).sum((0, 1))[:, None]
    db2 = (r * _alpha_rest(a, key_mask)).sum().reshape(1, 1)
    d_z = d_a[:, :, None] * w2[:, 0].float() * (1.0 - e * e)
    db1 = d_z.sum((0, 1))[None, :]
    dw1 = _dw1(ctx, d_z)
    d_ctx = d_ctx + _dctx_of_dz(d_z, w1)
    if _dropout_on(drop_rate, deterministic):
        d_ctx = d_ctx * keep_mask(d_ctx.shape, drop_rate, seed)
    dqkv = fa.qkv_bwd_probs_reference(qkv, qkv.new_zeros(qkv.shape[-1]),
                                      probs, d_ctx.to(qkv.dtype), n_heads)
    return dqkv, dw1, db1, dw2, db2


# ---- the kernels ----------------------------------------------------------


def _dropout_args(drop_rate, deterministic):
    """(use, threshold, scale) as the kernels take them."""
    if not _dropout_on(drop_rate, deterministic):
        return 0, 0, 1.0
    return 1, drop_threshold(drop_rate), 1.0 / (1.0 - drop_rate)


def _check_launch(qkv, key_mask, w1, b1, w2, b2, seed, *more):
    kernels.check_operands(qkv, key_mask, w1, b1, w2, b2, seed, *more)
    for name, x, dtype in (("w1", w1, qkv.dtype), ("w2", w2, qkv.dtype),
                           ("b1", b1, torch.float32),
                           ("b2", b2, torch.float32),
                           ("seed", seed, torch.int32)):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")


# ---- the launch plan ------------------------------------------------------

TAIL_REGIMES = ("resident", "global", "tiled")
# Blocks an SM holds of the resident kernels by itemsize: their registers
# allow three in bf16 and two in f32 at heads of up to 24 lanes
# (csrc/fused_tail.cuh tail_blocks), so a plan gains nothing from shared
# memory for more.
RESIDENT_BLOCKS = {2: 3, 4: 2}
# The tiled regime (csrc/fused_tail.cuh): an attention block takes one
# (row, head) and the row's queries in sub-tiles of the first of TILE_MS
# whose block fits; heads of up to TILE_MAX_HEAD; a pooling or d_ctx block
# takes POOL_ROWS positions.
TILE_MS = (64, 32, 16)
TILE_MAX_HEAD = 64
POOL_ROWS = 40


class TailPlan(NamedTuple):
    """The regime of row 13 or 14 (``TAIL_REGIMES``) and, resident, its
    launch: an item of one batch row walked as sub-items of ``heads``
    heads, ``nbuf`` stage buffers, ``blocks`` blocks of ``smem`` bytes; in
    the bf16 backward also row 16's plan (``attn``) for the attention
    part. Tiled: the queries of an attention sub-tile (``tile``) and that
    block's ``smem`` bytes."""
    regime: str
    heads: int = 0
    nbuf: int = 0
    blocks: int = 0
    smem: int = 0
    attn: bl.Plan | None = None
    tile: int = 0

    def args(self) -> tuple:
        """The regime's code, the resident plan and the tiled regime's
        sub-tile, as the C entry points take them (zeros outside their
        regimes)."""
        return (TAIL_REGIMES.index(self.regime), self.heads, self.nbuf,
                self.blocks, self.tile)

    def attn_args(self) -> tuple:
        """Row 16's (heads, nbuf, blocks), zeros where row 4 takes the
        attention backward."""
        a = self.attn
        return (0, 0, 0) if a is None else (a.heads, a.nbuf, a.blocks)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def resident_smem(kind: str, t: int, n_heads: int, d: int, q: int,
                  itemsize: int, heads: int, nbuf: int) -> int:
    """Shared bytes of a resident block (csrc/fused_tail.cuh ``tail_res``):
    ``nbuf`` of row 15's stage buffers; row 15's f32 arrays sharing their
    bytes with e (T rows of ``tail_es(Q)``, in the input dtype in the
    forward, f32 in the backward); the f32 ctx (T rows of
    ``tail_cs(HD)``); alpha, and in the backward d_alpha, g and 1 -
    sum(alpha)."""
    f32_arrays = bl.smem_bytes("fwd", t, d, itemsize, heads, t, 0)
    stage = bl.smem_bytes("fwd", t, d, itemsize, heads, t, 1) - f32_arrays
    hd = n_heads * d
    cs = -(-hd // 32) * 32 + 16
    es = -(-q // 32) * 32 + 16
    e_bytes = t * es * (4 if kind == "bwd" else itemsize)
    small = t if kind == "fwd" else 2 * t + hd + 1
    return (nbuf * stage + _round16(max(f32_arrays, e_bytes))
            + t * cs * 4 + _round16(4 * small))


def tiled_smem(t: int, d: int, m: int) -> int:
    """Shared bytes of a tiled attention block (csrc/fused_tail.cuh
    ``tile_lay``): the head's K^T (D rows of kw + 4 floats, kw = T rounded
    up to 64) and V (t4 rows of D rounded up to 4, t4 = T rounded up to 4),
    then a sub-tile's Q^T (D rows of m), scores (m rows of kw + 4 floats)
    and its rows' maxima per 64 keys (kw / 64 by m)."""
    t4 = -(-t // 4) * 4
    kw = -(-t4 // 64) * 64
    vs = -(-d // 4) * 4
    return 4 * (d * (kw + 4) + t4 * vs + d * m + m * (kw + 4) + kw // 64 * m)


def tile_m(t: int, d: int) -> int:
    """The tiled attention's sub-tile at (T, D): the first of TILE_MS whose
    block fits, 0 where none does."""
    return next((m for m in TILE_MS if tiled_smem(t, d, m)
                 <= kernels.MAX_SMEM), 0)


def pool_smem(hd: int, q: int) -> int:
    """Shared bytes of a tiled pooling block: POOL_ROWS rows of the f32
    context and of e, at the resident layout's row strides."""
    return 4 * POOL_ROWS * (-(-hd // 32) * 32 + 16 + -(-q // 32) * 32 + 16)


def tail_regime(kind: str, t: int, n_heads: int, d: int, q: int,
                itemsize: int) -> str:
    """"resident" at T <= 64 with heads of up to 64 where one row, one head
    and one buffer fit a block; else "tiled" with heads of up to 64 while
    a head's K and V and 16 queries' probs fit an attention block (T up to
    1024 at D = 20) and 40 positions' context and e a pooling block; else
    "global", the per-row kernel with its working set in global memory."""
    if (t <= bl.SHORT_T and d <= bl.MAX_HEAD and resident_smem(
            kind, t, n_heads, d, q, itemsize, 1, 1) <= kernels.MAX_SMEM):
        return "resident"
    if (d <= TILE_MAX_HEAD and tile_m(t, d)
            and pool_smem(n_heads * d, q) <= kernels.MAX_SMEM):
        return "tiled"
    return "global"


@functools.lru_cache(maxsize=256)
def tail_launch_plan(kind: str, n: int, t: int, n_heads: int, d: int, q: int,
                     dtype, sms: int = 132) -> TailPlan:
    """The regime and launch of row 13 (``kind`` "fwd") or row 14 ("bwd")
    at (N, T, H, D, Q) in ``dtype``. Tiled: the sub-tile and block bytes of
    its attention (``tile_m``). Resident: items of one batch row; the
    first of four heads a sub-item (then two, one) and two stage buffers
    (then one) that puts on an SM as many blocks as the rows fill, up to
    the most that fit (at most RESIDENT_BLOCKS); the grid the rows, at
    most as many blocks as the SMs hold. The bf16 backward adds row 16's
    plan (``experimental_blanes.launch_plan``); the f32 one takes row 4's
    kernel. A function of the shapes and the card alone."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    regime = tail_regime(kind, t, n_heads, d, q, itemsize)
    if regime == "tiled":
        m = tile_m(t, d)
        return TailPlan(regime, smem=tiled_smem(t, d, m), tile=m)
    if regime != "resident":
        return TailPlan(regime)
    fits = []
    for heads in dict.fromkeys(min(n_heads, g) for g in (4, 2, 1)):
        for nbuf in (2, 1):
            smem = resident_smem(kind, t, n_heads, d, q, itemsize, heads,
                                 nbuf)
            if smem <= kernels.MAX_SMEM:
                fits.append((min(RESIDENT_BLOCKS[itemsize],
                                 bl.SM_SMEM // (smem + 1024)),
                             heads, nbuf, smem))
    need = min(max(f[0] for f in fits), -(-n // sms))
    per_sm, heads, nbuf, smem = next(f for f in fits if f[0] >= need)
    attn = (bl.launch_plan("bwd", n, t, n_heads, d, itemsize, sms)
            if kind == "bwd" and itemsize == 2 else None)
    return TailPlan(regime, heads, nbuf, min(n, sms * per_sm), smem, attn)


# ---- the kernels ----------------------------------------------------------


def fused_tail_fwd(qkv, key_mask, w1, b1, w2, b2, seed, n_heads: int,
                   drop_rate: float, deterministic: bool):
    """Kernel row 13 on CUDA tensors, with the plain version's contract;
    w1 and w2 in qkv's dtype, b1 and b2 float32, seed int32. Raises for
    other devices."""
    n, t, d, q = _check(qkv, key_mask, w1, b1, w2, b2, seed, n_heads)
    _check_launch(qkv, key_mask, w1, b1, w2, b2, seed)
    plan = tail_launch_plan("fwd", n, t, n_heads, d, q, qkv.dtype,
                            blockwise._sms(qkv.device))
    out = torch.empty((n, n_heads * d), dtype=qkv.dtype, device=qkv.device)
    scratch, slots = None, 0
    if plan.regime == "global":
        scratch, slots = kernels.scratch("fused_tail_fwd",
                                         "fused_tail_fwd_scratch_floats", n,
                                         qkv.device, t, n_heads, d, q)
    elif plan.regime == "tiled":  # the f32 context and the scores
        scratch = kernels.rows_scratch("fused_tail_fwd",
                                       "fused_tail_fwd_row_floats", n,
                                       qkv.device, t, n_heads, d, q,
                                       qkv.element_size())
    kernels.call("tail" if key_mask is None else "tail_masked",
                 kernels.entry("fused_tail_fwd", "fused_tail_fwd",
                               qkv.dtype),
                 qkv.device, *map(kernels.ptr, (qkv, key_mask, w1, b1, w2,
                                                b2, seed, out, scratch)),
                 n, t, n_heads, d, q, *plan.args(), slots,
                 *_dropout_args(drop_rate, deterministic),
                 regime=plan.regime)
    return out


def _n_splits(n_pos, hd, q, device) -> int:
    """Row 14's splits of the N*T positions for the dw1 product: about four
    blocks of 64 x 128 outputs per SM, none under 32 positions. A function
    of the shapes and the card, so two runs sum in the same order."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-hd // 64) * -(-q // 128)
    return max(1, min(-(-n_pos // 32), -(-4 * sms // tiles)))


def fused_tail_bwd(qkv, key_mask, w1, b1, w2, b2, seed, g, n_heads: int,
                   drop_rate: float, deterministic: bool):
    """Kernel row 14 on CUDA tensors, with the plain version's contract.
    The parameter gradients are summed in a fixed order (per row, per split
    of the positions, then over rows and splits), so two runs give the
    same bits. Raises for other devices."""
    n, t, d, q = _check(qkv, key_mask, w1, b1, w2, b2, seed, n_heads)
    hd = n_heads * d
    if g.shape != (n, hd) or g.dtype != qkv.dtype:
        raise ValueError(f"g must be {qkv.dtype} ({n}, {hd}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _check_launch(qkv, key_mask, w1, b1, w2, b2, seed, g)
    dev = qkv.device
    splits = _n_splits(n * t, hd, q, dev)
    plan = tail_launch_plan("bwd", n, t, n_heads, d, q, qkv.dtype,
                            blockwise._sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = (torch.empty((n, t, hd), dtype=qkv.dtype, device=dev),
               torch.empty((n, t, hd), **f32), torch.empty((n, t, q), **f32),
               torch.empty((n, 2 * q + 1), **f32),
               torch.empty((splits, hd, q), **f32))
    dqkv = torch.empty_like(qkv)
    dw1, db1 = torch.empty((hd, q), **f32), torch.empty((1, q), **f32)
    dw2, db2 = torch.empty((q, 1), **f32), torch.empty((1, 1), **f32)
    w1t = w1.t().contiguous()  # (Q, HD): the d_z w1^T product reads rows
    zero_bias = stage = attn_stage = attn_stats = None
    slots = attn_slots = 0
    row4 = (0,) * 6
    if plan.attn is None:  # row 4's kernel takes the attention backward
        if plan.regime == "tiled":  # the rows' scores and d_alpha
            stage = kernels.rows_scratch("fused_tail_bwd",
                                         "fused_tail_bwd_row_floats", n, dev,
                                         t, n_heads, d, q,
                                         qkv.element_size())
        elif plan.regime == "global":
            # q, k, v of the per-row kernel staged in global memory, one
            # slot per block
            stage, slots = kernels.scratch("fused_tail_bwd",
                                           "fused_tail_bwd_stage_floats", n,
                                           dev, t, n_heads, d, q)
        # row 4's part in its regime: the plan and row stats on tensor
        # cores, or its tiled kernel's global slots
        attn = fa.bwd_launch_plan(n, t, n_heads, d, qkv.dtype,
                                  blockwise._sms(dev))
        if attn.regime != "resident":  # its other kernels add a bias
            zero_bias = qkv.new_zeros(3 * hd)
        _, attn_stats, attn_stage, attn_slots = fa.bwd_work(
            "fused_tail_bwd", "fused_tail_bwd_attn_stage_floats", attn, qkv,
            n, t, n_heads, d, biased=True)
        row4 = attn.args()
    kernels.call("tail_bwd" if key_mask is None else "tail_bwd_masked",
                 kernels.entry("fused_tail_bwd", "fused_tail_bwd",
                               qkv.dtype),
                 dev, *map(kernels.ptr, (qkv, key_mask, w1, w1t, b1, w2, b2,
                                         seed, g, zero_bias, dqkv, *scratch,
                                         dw1, db1, dw2, db2, stage,
                                         attn_stage, attn_stats)),
                 n, t, n_heads, d, q, splits, slots, attn_slots, *row4,
                 *plan.args(), *plan.attn_args(),
                 *_dropout_args(drop_rate, deterministic),
                 regime=plan.regime)
    return dqkv, dw1, db1, dw2, db2


# ---- autograd -------------------------------------------------------------


class _ExpMhsaPool(torch.autograd.Function):
    """Row 13 forward, saving qkv, the mask, the pooling params and the
    seed; row 14 backward, which recomputes the tail from them. The plain
    versions for CPU tensors. dw1 and dw2 come back in w1's and w2's
    dtype, db1 and db2 in f32; the mask and the seed get none."""

    @staticmethod
    def forward(ctx, qkv, key_mask, w1, b1, w2, b2, seed, n_heads, drop_rate,
                deterministic):
        fwd = (fused_tail_fwd_reference if qkv.device.type == "cpu"
               else fused_tail_fwd)
        ctx.args = (n_heads, drop_rate, deterministic)
        ctx.save_for_backward(qkv, key_mask, w1, b1, w2, b2, seed)
        return fwd(qkv, key_mask, w1, b1, w2, b2, seed, *ctx.args)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, key_mask, w1, b1, w2, b2, seed = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        bwd = (fused_tail_bwd_reference if qkv.device.type == "cpu"
               else fused_tail_bwd)
        dqkv, dw1, db1, dw2, db2 = bwd(qkv, key_mask, w1, b1, w2, b2, seed,
                                       g, *ctx.args)
        return (dqkv, None, dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None, None, None)


def _pool(qkv, key_mask, w1, b1, w2, b2, seed, n_heads, drop_rate,
          deterministic):
    args = (qkv, key_mask, w1, b1, w2, b2, seed, n_heads, float(drop_rate),
            bool(deterministic))
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (qkv, w1, b1, w2, b2)):
        return _ExpMhsaPool.apply(*args)
    if qkv.device.type == "cpu":
        return fused_tail_fwd_reference(*args)
    return fused_tail_fwd(*args)


def exp_mhsa_pool(qkv, w1, b1, w2, b2, seed, n_heads: int, drop_rate: float,
                  deterministic: bool):
    """The fused unmasked encoder tail: biased qkv (N, T, 3HD); pooling
    params w1 (HD, Q), b1 (1, Q), w2 (Q, 1), b2 (1, 1); seed (1,) int32.
    Returns the pooled (N, HD) in qkv's dtype, differentiable in qkv and
    the four params."""
    return _pool(qkv, None, w1, b1, w2, b2, seed, n_heads, drop_rate,
                 deterministic)


def exp_mhsa_pool_masked(qkv, key_mask, w1, b1, w2, b2, seed, n_heads: int,
                         drop_rate: float, deterministic: bool):
    """The key-masked fused tail: the 0/1 key_mask (N, T) float32 multiplies
    after the exp in both the attention and the pooling scores."""
    return _pool(qkv, key_mask, w1, b1, w2, b2, seed, n_heads, drop_rate,
                 deterministic)
