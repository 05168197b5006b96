"""Exp-MHSA over a fused [q|k|v] projection: four CUDA kernels behind two
autograd-aware wrappers, and their plain PyTorch versions.

Replaces, in ``newsrecommendation_tpu/ops/pallas/fused_attention.py``:
  - ``_qkv_fwd_call`` (``_qkv_fwd_kernel``): the forward, for serving,
    eval and training with bwd_residuals "recompute" -> ``csrc/qkv_fwd.cu``,
    kernel "qkv_fwd" (row 1);
  - ``_qkv_fwd_probs_call``: the same forward that also writes the f32
    probs (N, T, H*T), under differentiation with bwd_residuals "probs" ->
    ``csrc/qkv_fwd.cu`` with a probs pointer, kernel "qkv_fwd_probs"
    (row 2). Rows 1 and 2 share one launch in four regimes that
    ``fwd_launch_plan`` chooses by T, D and the dtype (resident, tensor
    cores, tiled, row-wise); row 2's context is row 1's bit for bit;
  - ``_qkv_bwd_probs_call`` (``_qkv_bwd_probs_kernel``): the backward from
    those probs -> ``csrc/qkv_bwd_probs.cu``, kernel "qkv_bwd_probs"
    (row 3);
  - ``_qkv_bwd_call`` (``_qkv_bwd_kernel``): the backward that recomputes
    the probs from qkv, bias and the mask -> ``csrc/qkv_bwd.cu``, kernel
    "qkv_bwd" (row 4). Rows 3 and 4 share one kernel template
    (``csrc/qkv_bwd.cuh``) in four regimes that ``bwd_launch_plan``
    chooses by T, D and the dtype; in all but the tensor-core one they
    give the same gradients bit for bit.
and, on separate q, k and v (the JAX package's route when the q/k/v
widths differ), ``_fwd_call`` / ``_masked_fwd_call`` and ``_bwd_call`` /
``_masked_bwd_call`` -> ``csrc/mhsa_sep.cu``, kernels "mhsa_fwd" (rows 5
and 7, in the three regimes of ``sep_fwd_launch_plan``: row-wise, tensor
cores, tiled) and "mhsa_bwd" (rows 6 and 8, in the three regimes of
``sep_bwd_launch_plan``: resident, tensor cores, wide), behind ``exp_mhsa``
and ``exp_mhsa_masked``. Those take d_v as a width of its own: the TPU
kernels size the output and v's head slice by q's width, which is right
only when the widths are equal, so the port is held to them there and, at
unequal widths, to the JAX package with Pallas off.
The entry points ``exp_mhsa_qkv_bias`` and ``exp_mhsa_qkv_bias_masked``
choose as the JAX package's custom_vjp does: with grad mode on and qkv or
bias requiring grad, the forward and backward follow
``kernel_config.bwd_residuals()``; otherwise (serving under
inference_mode) the forward is row 1.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Nothing falls back.
Builds and launch counts: ``ops/kernels.py``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import blockwise, kernel_config, kernels
from newsrecommendation_tpu_torch.ops.attention import masked_exp_normalize
from newsrecommendation_tpu_torch.ops.kernels import (  # noqa: F401
    KERNELS,
    build,
    launch_counts,
    regime_counts,
    reset_launch_counts,
)


def _check(qkv, bias, key_mask, n_heads):
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, T, 3*H*D), got {tuple(qkv.shape)}")
    n, t, w3 = qkv.shape
    if n_heads < 1 or w3 % (3 * n_heads) != 0:
        raise ValueError(f"qkv width {w3} is not 3 * n_heads({n_heads}) * D")
    if bias.shape != (w3,):
        raise ValueError(f"bias must be ({w3},), got {tuple(bias.shape)}")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, w3 // (3 * n_heads)


def _check_bwd(qkv, bias, probs, g, n_heads):
    n, t, d = _check(qkv, bias, None, n_heads)
    if probs.shape != (n, t, n_heads * t) or probs.dtype != torch.float32:
        raise ValueError(f"probs must be float32 ({n}, {t}, {n_heads * t}), "
                         f"got {probs.dtype} {tuple(probs.shape)}")
    _check_grad(g, qkv, n, t, n_heads * d)
    return n, t, d


def _check_launch(qkv, bias, key_mask, *more):
    """What every kernel of rows 1-4 needs of its operands; raises on the
    rest."""
    kernels.check_operands(qkv, bias, key_mask, *more)
    if bias.dtype != qkv.dtype:
        raise TypeError(f"bias dtype {bias.dtype} != qkv dtype {qkv.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")


def _launch(variant, qkv, bias, key_mask, n_heads, with_probs=False):
    """Row 1 (returns ctx) or, with_probs, row 2 (returns ctx, probs), in
    the regime of ``fwd_launch_plan``."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    _check_launch(qkv, bias, key_mask)
    out = torch.empty((n, t, n_heads * d), dtype=qkv.dtype,
                      device=qkv.device)
    if not with_probs:
        fwd_call(variant, qkv, bias, key_mask, out, None, n, t, n_heads, d)
        return out
    probs = torch.empty((n, t, n_heads * t), dtype=torch.float32,
                        device=qkv.device)
    fwd_call(variant, qkv, bias, key_mask, out, probs, n, t, n_heads, d)
    return out, probs


def fwd_call(variant, qkv, bias, key_mask, out, probs, n: int, t: int,
             n_heads: int, d: int) -> None:
    """One launch of row 1 (``probs`` None) or row 2 (and 11, on the
    (N, T, 3HD) view of its input) in ``fwd_launch_plan``'s regime,
    counted under ``variant``: its entry point in ``csrc/qkv_fwd.cu``
    takes the regime's index and the plan's three ints; on tensor cores
    also the biased qkv its bias pass writes, row-wise past shared memory
    (T > 235 at D = 80) a global slot per block for q, k, v and the score
    rows."""
    plan = fwd_launch_plan(n, t, n_heads, d, qkv.dtype,
                           blockwise._sms(qkv.device),
                           probs=probs is not None)
    biased = torch.empty_like(qkv) if plan.regime == "mma" else None
    stage, slots = None, 0
    if plan.regime == "rowwise":
        stage, slots = kernels.scratch("qkv_fwd", "qkv_fwd_slot_floats",
                                       n * n_heads, qkv.device, t, d)
    ptrs = [qkv.data_ptr(), bias.data_ptr(), kernels.ptr(key_mask),
            out.data_ptr()]
    if probs is not None:
        ptrs.append(probs.data_ptr())
    fn = kernels.entry("qkv_fwd", "qkv_fwd" if probs is None
                       else "qkv_fwd_probs", qkv.dtype)
    kernels.call(variant, fn, qkv.device, *ptrs, kernels.ptr(biased),
                 kernels.ptr(stage), n, t, n_heads, d,
                 FWD_REGIMES.index(plan.regime), *plan.args(), slots,
                 regime=plan.regime)


# ---- rows 1-2 (and 11): the launch plan -------------------------------------

FWD_REGIMES = ("resident", "mma", "tiled", "rowwise")
FWD_SHORT_T = 64  # longest T of the resident regime (blanes_resident.cuh)
FWD_MAX_HEAD = 64  # widest head of every regime but "rowwise"
# Row 2's probs leave the tensor-core and tiled kernels through shared
# memory, FWD_PROBS_KEYS keys of a row at a time (csrc/mhsa_sep_fwd.cuh
# kProbsKeys): the tiled block stages its queries' a in rows of
# FWD_PROBS_ROW floats, each tensor-core warp its 16 queries' in rows of
# FWD_MMA_PROBS_ROW.
FWD_PROBS_KEYS = 32
FWD_PROBS_ROW = FWD_PROBS_KEYS + 1
FWD_MMA_PROBS_ROW = FWD_PROBS_KEYS + 8
# The tiled kernel's compile-time widths (qkv_tiled_width): row 9's, and
# 20, the NRMS head.
FWD_TILED_WIDTHS = (8, 16, 20, 24, 32, 64)


def fwd_regime(t: int, d: int, itemsize: int) -> str:
    """The regime of rows 1-2 (and 11) at (T, D) (``csrc/qkv_fwd.cuh``
    ``qf::regime``): "resident" (row 15's design) at T <= 64, past it
    "mma" (tensor cores) in bf16 and "tiled" (CUDA cores) in f32, each with
    heads of up to 64; "rowwise" (the first port's kernel) for wider
    heads at any T."""
    if d > FWD_MAX_HEAD:
        return "rowwise"
    if t <= FWD_SHORT_T:
        return "resident"
    return "mma" if itemsize == 2 else "tiled"


class FwdPlan(NamedTuple):
    """The regime of rows 1-2 (``FWD_REGIMES``) and its launch: the
    resident kernel's (``experimental_blanes.Plan``), or the tensor-core or
    tiled kernel's (``blockwise.Launch``); none row-wise."""
    regime: str
    resident: NamedTuple | None = None
    launch: blockwise.Launch | None = None

    def args(self) -> tuple:
        """The three ints the C entry points take: resident (heads, nbuf,
        blocks); tensor cores and tiled (tile, chunk, nbuf); row-wise
        zeros."""
        if self.resident is not None:
            r = self.resident
            return (r.heads, r.nbuf, r.blocks)
        if self.launch is not None:
            p = self.launch
            return (p.tile, p.chunk, p.nbuf)
        return (0,) * 3


def fwd_tiled_smem(d: int, probs: bool) -> int:
    """Shared bytes of a tiled block (``tiled_smem_at``): SEP_TILED_CHUNK
    keys of K and V at the least of FWD_TILED_WIDTHS that holds d, and of
    the mask, f32; with probs a tile of SEP_TILED_THREADS rows of
    FWD_PROBS_ROW floats."""
    width = next(w for w in FWD_TILED_WIDTHS if d <= w)
    return 4 * (SEP_TILED_CHUNK * (2 * width + 1)
                + (SEP_TILED_THREADS * FWD_PROBS_ROW if probs else 0))


# Cached: worked out in Python the plan takes tens of microseconds, about
# as long as row 1 runs on a served batch (64, 50).
@functools.lru_cache(maxsize=256)
def fwd_launch_plan(n: int, t: int, heads: int, d: int, dtype,
                    sms: int = 132, probs: bool = False) -> FwdPlan:
    """The regime and launch of rows 1-2 (and 11) at (N, T, H, D) in
    ``dtype``; ``probs`` for row 2 (and 11). Resident: row 15's forward
    layout and plan (``experimental_blanes.launch_plan``: up to four heads
    an item and two buffers, as many blocks as the card holds); tensor
    cores: rows 5 and 7's (row 9's forward layout,
    ``blockwise.mma_launch`` of kind "fwd": a block per (row, head) and
    tile of 128 or 64 queries, K, V and the mask in chunks over all T
    keys, on a biased copy of qkv; row 2 adds a probs tile per warp);
    tiled: a block of
    SEP_TILED_THREADS threads per (row, head), one query a thread,
    SEP_TILED_CHUNK keys staged at once (``fwd_tiled_smem``); row-wise, no
    plan. A dtype other than float32 and bfloat16 raises TypeError."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    regime = fwd_regime(t, d, itemsize)
    rows = n * heads
    if regime == "resident":  # the bias and probs take no shared memory
        from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

        return FwdPlan(regime, resident=bl.launch_plan("fwd", n, t, heads, d,
                                                       itemsize, sms))
    if regime == "mma":
        tile = blockwise.mma_tile(rows, t, sms)
        launch = blockwise.mma_launch("fwd", d, itemsize, tile, t,
                                      (rows, -(-t // tile)))
        if probs:  # a probs tile per warp of 16 queries
            launch = launch._replace(
                smem=launch.smem + 4 * tile * FWD_MMA_PROBS_ROW)
        return FwdPlan(regime, launch=launch)
    if regime == "tiled":
        tile = SEP_TILED_THREADS
        return FwdPlan(regime, launch=blockwise.Launch(
            "qkv_fwd_tiled", tile, SEP_TILED_CHUNK, 1,
            fwd_tiled_smem(d, probs), (rows, -(-t // tile)), tile))
    return FwdPlan(regime)


# ---- rows 3-4: the launch plan ---------------------------------------------

_SMEM_FLOATS = kernels.MAX_SMEM // 4
_RESIDENT_WARPS, _TILED_WARPS = 4, 8
REGIMES = ("resident", "mma", "tiled", "tiled_global")
# The short resident kernel (csrc/qkv_bwd.cuh qb::): T and D it takes,
# its threads, and the blocks an SM holds by its registers
# (__launch_bounds__, qb::blocks_per_sm): row 3's, row 4's.
RES_SHORT_T, RES_SHORT_D = 64, 32
RES_THREADS = 256
RES_PER_SM = {True: 3, False: 2}


def resident(t: int, d: int) -> bool:
    """Whether the resident regime takes (T, D): where the first design's
    kernel holds q, k, v, g (T x (D|1)), the T x (T|1) block of a and a row
    per warp, in f32 (``csrc/qkv_bwd.cuh`` qkv_bwd_resident); T <= 201 at
    D = 20."""
    return (4 * t * (d | 1) + t * (t | 1) + _RESIDENT_WARPS * t
            <= _SMEM_FLOATS)


def short_resident(t: int, d: int) -> bool:
    """Whether the resident regime takes (T, D) on the short kernel (T <=
    64, heads of up to 32: the news and L = 50 user encoders); its other
    shapes keep the first design's kernel."""
    return t <= RES_SHORT_T and d <= RES_SHORT_D


def _odd_units(nbytes: int) -> int:
    """16-byte units of ``nbytes``, made odd (``qb::odd_units``)."""
    u = -(-nbytes // 16)
    return u if u % 2 else u + 1


def resident_smem(t: int, d: int, itemsize: int, heads: int, nbuf: int,
                  probs: bool) -> int:
    """Shared bytes of a short-kernel block (``qb::shape_of``): ``nbuf``
    stage buffers of q, k, v, g rows in the input dtype (f32: each head at
    core_dm(D) floats; bf16: one run of the item's heads), rows an odd
    number of 16-byte units apart, row 3's probs rows (``probs``) and
    three runs of the item's bias; bf16 the f32 rows of q, k, v, g; then
    round(a), ds and ds^T, each (heads, T, T to 4) f32."""
    dm = blockwise._core_width(d)
    rsf = _odd_units(heads * dm * 4) * 4
    rsr = rsf if itemsize == 4 else (_odd_units(heads * d * itemsize) * 16
                                     // itemsize)
    stage = (4 * t * rsr * itemsize
             + (t * -(-heads * t // 4) * 4 * 4 if probs else 0)
             + 3 * -(-heads * d * itemsize // 16) * 16)
    work = 4 * t * rsf * 4 if itemsize == 2 else 0
    return nbuf * stage + work + 3 * heads * t * -(-t // 4) * 4 * 4


def _tiled_in_smem(t: int, d: int) -> bool:
    """Whether the tiled kernel's q, k, v, g fit beside its row buffers,
    row stats and two tile rows (``qkv_bwd_tiled_in_smem``)."""
    return (4 * t * (d | 1) + (_TILED_WARPS + 3) * t + 2 * (t | 1)
            <= _SMEM_FLOATS)


class ResidentPlan(NamedTuple):
    """The resident regime's launch: ``items`` work items of one batch row
    and ``heads`` heads (the short kernel) or of one (row, head) (the
    first design's, heads 1), ``nbuf`` stage buffers, ``blocks`` blocks of
    ``threads`` walking the items, ``smem`` bytes each."""
    heads: int
    nbuf: int
    items: int
    blocks: int
    threads: int
    smem: int


def resident_plan(n: int, t: int, heads: int, d: int, itemsize: int,
                  sms: int, probs: bool) -> ResidentPlan:
    """The resident regime's launch at (N, T, H, D). The short kernel: the
    first of four heads an item (H where it is smaller), then two, then
    one, with two stage buffers, then one, whose block leaves room for
    RES_PER_SM[probs] blocks on an SM (three for row 3, two for row 4, as
    their registers allow), else the first that fits a block; as many
    blocks as the SMs hold, at most one per item. The first design's
    kernel: a block of 128 threads per (row, head)."""
    if not short_resident(t, d):
        smem = 4 * (4 * t * (d | 1) + t * (t | 1) + _RESIDENT_WARPS * t)
        return ResidentPlan(1, 1, n * heads, n * heads, 32 * _RESIDENT_WARPS,
                            smem)
    most = RES_PER_SM[probs]
    fits = []
    for g in dict.fromkeys(min(heads, x) for x in (4, 2, 1)):
        for nbuf in (2, 1):
            smem = resident_smem(t, d, itemsize, g, nbuf, probs)
            if smem <= kernels.MAX_SMEM:
                fits.append((min(most, blockwise.SM_SMEM // (smem + 1024)),
                             g, nbuf, smem))
    per_sm, g, nbuf, smem = next((f for f in fits if f[0] >= most), fits[0])
    items = n * -(-heads // g)
    return ResidentPlan(g, nbuf, items, min(items, sms * per_sm),
                        RES_THREADS, smem)


class BwdPlan(NamedTuple):
    """The regime of rows 3-4 (``REGIMES``) and its launches: on tensor
    cores the query side (first) and the key side (``blockwise.Launch``:
    tile, chunk, buffers, shared bytes, grid, threads); resident
    ``ResidentPlan``."""
    regime: str
    query: blockwise.Launch | None = None
    key: blockwise.Launch | None = None
    resident: ResidentPlan | None = None

    def args(self) -> tuple:
        """The six ints the C entry points take: resident (heads, nbuf,
        blocks, threads, shared bytes, 0); on tensor cores (tile, chunk,
        nbuf) of the query side, then of the key side; zeros tiled."""
        if self.resident is not None:
            r = self.resident
            return (r.heads, r.nbuf, r.blocks, r.threads, r.smem, 0)
        if self.regime != "mma":
            return (0,) * 6
        return tuple(x for p in (self.query, self.key)
                     for x in (p.tile, p.chunk, p.nbuf))


# Cached, as fwd_launch_plan is: the resident plan's search takes tens of
# microseconds in Python, about as long as the (128, 50) kernel runs.
@functools.lru_cache(maxsize=256)
def bwd_launch_plan(n: int, t: int, heads: int, d: int, dtype,
                    sms: int = 132, probs: bool = False) -> BwdPlan:
    """The regime and launches of rows 3-4 (and 12, and row 14's attention
    part) at (N, T, H, D) in ``dtype``; ``probs`` for row 3 (and 12),
    which reads the f32 probs. Resident where the first design's kernel
    holds (T, D) (T <= 201 at D = 20, both dtypes; ``resident_plan``:
    the short kernel at T <= 64 and heads of up to 32); past it, bf16 heads
    of up to 64 on tensor cores, each side a block per (row, head) and tile
    of 128 own rows (64 when that leaves fewer than two blocks per SM), the
    other side staged in chunks (``blockwise.mma_launch``), with row 3's
    probs tile; f32 and wider heads on the tiled CUDA-core kernel, in
    shared memory while it fits and in one global slot per block past it.
    Every T and D has a plan; a dtype other than float32 and bfloat16
    raises TypeError."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if resident(t, d):
        return BwdPlan("resident", resident=resident_plan(
            n, t, heads, d, itemsize, sms, probs))
    if blockwise.uses_mma(d, itemsize):
        return BwdPlan("mma", *_mma_sides(n, t, heads, d, itemsize, sms,
                                           "_probs" if probs else ""))
    return BwdPlan("tiled" if _tiled_in_smem(t, d) else "tiled_global")


def _mma_sides(n, t, heads, d, itemsize, sms, suffix=""):
    """The tensor-core backward's query-side and key-side launches
    (``blockwise.mma_launch`` of kind "bwd_query" / "bwd_key" + suffix):
    a block per (row, head) and tile of ``blockwise.mma_tile`` own rows,
    the other side's T rows in chunks."""
    rows = n * heads
    tile = blockwise.mma_tile(rows, t, sms)
    grid = (rows, -(-t // tile))
    return tuple(blockwise.mma_launch(kind + suffix, d, itemsize, tile, t,
                                      grid)
                 for kind in ("bwd_query", "bwd_key"))


def bwd_work(lib: str, fn: str, plan: BwdPlan, qkv, n: int, t: int,
             n_heads: int, d: int, biased: bool = False):
    """The scratch of a rows 3-4 launch in ``plan``'s regime: on tensor
    cores the biased qkv (unless ``biased``: qkv carries its bias) and the
    row stats (3, N*H, T) f32; for the tiled kernel in global memory its
    (stage, slots), sized by size function ``fn`` of source ``lib``.
    Returns (biased qkv, stats, stage, slots), None and 0 where the regime
    reads none."""
    work = stats = stage = None
    slots = 0
    if plan.regime == "mma":
        work = None if biased else torch.empty_like(qkv)
        stats = torch.empty((3, n * n_heads, t), dtype=torch.float32,
                            device=qkv.device)
    elif plan.regime == "tiled_global":
        stage, slots = kernels.scratch(lib, fn, n * n_heads, qkv.device, t,
                                       d, qkv.element_size())
    return work, stats, stage, slots


def _bwd_call(variant, lib, fn, qkv, bias, third, g, dqkv, n, t, n_heads,
              d):
    """Launch row 3 (third: probs; also row 12, on its 3-D view), 4 (lib
    "qkv_bwd"; third: the mask or None) in the regime of its plan. A bias
    of None: qkv carries its bias (rows 14 and 16 past their own kernels);
    the resident regime then adds none, the others a zero bias."""
    plan = bwd_launch_plan(n, t, n_heads, d, qkv.dtype,
                           blockwise._sms(qkv.device),
                           probs=lib != "qkv_bwd")
    if bias is None and plan.regime != "resident":
        bias = qkv.new_zeros(qkv.shape[-1])
    biased, stats, stage, slots = bwd_work(lib, f"{fn}_slot_floats", plan,
                                           qkv, n, t, n_heads, d)
    kernels.call(variant, kernels.entry(lib, fn, qkv.dtype), qkv.device,
                 qkv.data_ptr(), kernels.ptr(bias), kernels.ptr(third),
                 g.data_ptr(), dqkv.data_ptr(),
                 *map(kernels.ptr, (biased, stats, stage)),
                 n, t, n_heads, d, *plan.args(), slots, regime=plan.regime)


def qkv_fwd_probs(qkv, bias, key_mask, n_heads: int):
    """Kernel row 2 on CUDA tensors: (ctx, probs (N, T, H*T) f32), ctx bit
    for bit row 1's. key_mask may be None. Raises for other devices."""
    variant = "bias_probs" if key_mask is None else "bias_masked_probs"
    return _launch(variant, qkv, bias, key_mask, n_heads, with_probs=True)


def qkv_bwd_probs(qkv, bias, probs, g, n_heads: int):
    """Kernel row 3 on CUDA tensors: dqkv (N, T, 3HD) in qkv's dtype from
    the probs row 2 saved and the context's gradient g (N, T, HD) in qkv's
    dtype. Raises for other devices."""
    n, t, d = _check_bwd(qkv, bias, probs, g, n_heads)
    _check_launch(qkv, bias, None, probs, g)
    dqkv = torch.empty_like(qkv)
    _bwd_call("bwd_probs", "qkv_bwd_probs", "qkv_bwd_probs", qkv, bias,
              probs, g, dqkv, n, t, n_heads, d)
    return dqkv


def qkv_bwd(qkv, bias, key_mask, g, n_heads: int):
    """Kernel row 4 on CUDA tensors: dqkv (N, T, 3HD) in qkv's dtype from
    qkv, bias, the key mask (or None) and the context's gradient g
    (N, T, HD) in qkv's dtype, recomputing the probs as row 1 computes
    them. Raises for other devices."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    _check_grad(g, qkv, n, t, n_heads * d)
    _check_launch(qkv, bias, key_mask, g)
    dqkv = torch.empty_like(qkv)
    _bwd_call("bwd" if key_mask is None else "bwd_masked", "qkv_bwd",
              "qkv_bwd", qkv, bias, key_mask, g, dqkv, n, t, n_heads, d)
    return dqkv


def _split_heads(qkv, bias, n_heads, d):
    """Biased q, k, v (N, T, H, D) at the input dtype."""
    n, t, _ = qkv.shape
    x = qkv + bias.to(qkv.dtype)
    return [p.reshape(n, t, n_heads, d) for p in x.chunk(3, dim=-1)]


def exp_mhsa_qkv_bias_probs_reference(qkv, bias, key_mask, n_heads: int):
    """Plain PyTorch version of rows 1 and 2: same contract, same rounding
    points (bias added at the input dtype, f32 scores scaled after the dot,
    max over all keys, mask after the exp, a cast to v's dtype before a@v,
    f32 accumulate, output in the input dtype). key_mask may be None.
    Returns (ctx (N, T, H*D), probs (N, T, H*T) f32, head h's a at lanes
    [h*T, (h+1)*T))."""
    ctx, probs = attend_f32(qkv, bias, key_mask, n_heads)
    return ctx.to(qkv.dtype), probs


def attend_f32(qkv, bias, key_mask, n_heads: int):
    """Rows 1-2's plain arithmetic up to the context's f32 accumulate:
    (ctx (N, T, H*D) f32, not yet rounded to the input dtype, probs)."""
    n, t, d = _check(qkv, bias, key_mask, n_heads)
    q, k, v = _split_heads(qkv, bias, n_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    m = None if key_mask is None else key_mask[:, None, None, :]
    a = masked_exp_normalize(s, m, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).float(), v.float())
    probs = a.permute(0, 2, 1, 3).reshape(n, t, n_heads * t)
    return ctx.reshape(n, t, n_heads * d), probs


def exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads: int):
    """Plain PyTorch version of row 1: the context alone."""
    return exp_mhsa_qkv_bias_probs_reference(qkv, bias, key_mask, n_heads)[0]


def qkv_bwd_probs_reference(qkv, bias, probs, g, n_heads: int):
    """Plain PyTorch version of row 3, with the TPU kernel's rounding
    points: a rounded to g's dtype for dv = a^T g, da = g v^T in f32,
    ds = (da - rowsum(da * a)) * a / sqrt(D) with the f32 a, ds rounded to
    k's dtype before dq = ds k and dk = ds^T q. Returns dqkv in qkv's
    dtype."""
    n, t, d = _check_bwd(qkv, bias, probs, g, n_heads)
    q, k, v = (x.float() for x in _split_heads(qkv, bias, n_heads, d))
    gh = g.reshape(n, t, n_heads, d)
    a = probs.reshape(n, t, n_heads, t).permute(0, 2, 1, 3)  # (N, H, Q, K)
    dv = torch.einsum("bhqk,bqhd->bkhd", a.to(g.dtype).float(), gh.float())
    da = torch.einsum("bqhd,bkhd->bhqk", gh.float(), v)
    ds = (da - (da * a).sum(-1, keepdim=True)) * a * (1.0 / math.sqrt(d))
    ds = ds.to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return torch.cat([x.reshape(n, t, n_heads * d) for x in (dq, dk, dv)],
                     dim=-1).to(qkv.dtype)


def qkv_bwd_reference(qkv, bias, key_mask, g, n_heads: int):
    """Plain PyTorch version of row 4: the probs recomputed as rows 1-2's
    plain version computes them, then row 3's plain version. The JAX
    package states the two backwards equal bit for bit; here they are one
    computation."""
    probs = exp_mhsa_qkv_bias_probs_reference(qkv, bias, key_mask,
                                              n_heads)[1]
    return qkv_bwd_probs_reference(qkv, bias, probs, g, n_heads)


def _check_grad(g, like, n, t, width):
    if g.shape != (n, t, width) or g.dtype != like.dtype:
        raise ValueError(f"g must be {like.dtype} ({n}, {t}, {width}), "
                         f"got {g.dtype} {tuple(g.shape)}")


class _ExpMhsaQkvBias(torch.autograd.Function):
    """The fused-qkv attention under differentiation, as
    ``kernel_config.bwd_residuals()`` says when the forward runs: "probs",
    row 2 forward (saves qkv, bias and the f32 probs) and row 3 backward;
    "recompute", row 1 forward (saves qkv, bias and the mask) and row 4
    backward. Their plain versions for CPU tensors. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, key_mask, n_heads):
        cpu = qkv.device.type == "cpu"
        ctx.n_heads = n_heads
        ctx.recompute = kernel_config.bwd_residuals() == "recompute"
        if ctx.recompute:
            variant = "bias" if key_mask is None else "bias_masked"
            out = (exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads)
                   if cpu else _launch(variant, qkv, bias, key_mask, n_heads))
            ctx.save_for_backward(qkv, bias, key_mask)
            return out
        if cpu:
            out, probs = exp_mhsa_qkv_bias_probs_reference(qkv, bias,
                                                           key_mask, n_heads)
        else:
            out, probs = qkv_fwd_probs(qkv, bias, key_mask, n_heads)
        ctx.save_for_backward(qkv, bias, probs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qkv, bias, saved = ctx.saved_tensors
        # the gradient arrives in any layout and, under bf16 autocasts, in
        # any float type: the kernel takes it contiguous in qkv's dtype
        g = g.to(qkv.dtype).contiguous()
        cpu = qkv.device.type == "cpu"
        if ctx.recompute:
            bwd = qkv_bwd_reference if cpu else qkv_bwd
        else:
            bwd = qkv_bwd_probs_reference if cpu else qkv_bwd_probs
        dqkv = bwd(qkv, bias, saved, g, ctx.n_heads)
        dbias = (dqkv.sum((0, 1)).to(bias.dtype) if ctx.needs_input_grad[1]
                 else None)
        return dqkv, dbias, None, None


def _attend(variant, qkv, bias, key_mask, n_heads):
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _ExpMhsaQkvBias.apply(qkv, bias, key_mask, n_heads)
    if qkv.device.type == "cpu":
        return exp_mhsa_qkv_bias_reference(qkv, bias, key_mask, n_heads)
    return _launch(variant, qkv, bias, key_mask, n_heads)


def exp_mhsa_qkv_bias(qkv, bias, n_heads: int):
    """Exp-MHSA over an un-biased fused projection (N, T, 3HD) plus its bias
    (3HD,). Returns the context (N, T, HD), differentiable in qkv and bias."""
    return _attend("bias", qkv, bias, None, n_heads)


def exp_mhsa_qkv_bias_masked(qkv, bias, key_mask, n_heads: int):
    """Key-masked exp_mhsa_qkv_bias; key_mask (N, T) float32 0/1 over keys.
    A row whose keys are all masked gives 0."""
    return _attend("bias_masked", qkv, bias, key_mask, n_heads)


# ---- rows 5-8: separate q, k, v ---------------------------------------------


def _check_sep(q, k, v, key_mask, n_heads):
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or (
            v.shape[:2] != q.shape[:2]):
        raise ValueError(f"q, k must be (N, T, H*Dk) and v (N, T, H*Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, t, hdk = q.shape
    hdv = v.shape[-1]
    if n_heads < 1 or hdk % n_heads or hdv % n_heads:
        raise ValueError(f"widths {hdk}, {hdv} are not n_heads({n_heads}) "
                         "times a head width")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, hdk // n_heads, hdv // n_heads


def _sep_probs(q, k, key_mask, n_heads):
    """a (N, H, Tq, Tk) f32 of rows 5-8, and the f32 q, k by head."""
    n, t, hdk = q.shape
    dk = hdk // n_heads
    qh, kh = (x.reshape(n, t, n_heads, dk).float() for x in (q, k))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(dk))
    m = None if key_mask is None else key_mask[:, None, None, :]
    return masked_exp_normalize(s, m, dim=-1), qh, kh


def exp_mhsa_reference(q, k, v, key_mask, n_heads: int):
    """Plain PyTorch version of rows 5 and 7: the context (N, T, H*Dv) in
    q's dtype from q, k (N, T, H*Dk), v (N, T, H*Dv) and the key mask
    (N, T) f32 or None: scores f32 and scaled by 1/sqrt(Dk) after the dot,
    max over all keys, mask after the exp, a cast to v's dtype before a@v,
    f32 sums."""
    n, t, _, dv = _check_sep(q, k, v, key_mask, n_heads)
    a, _, _ = _sep_probs(q, k, key_mask, n_heads)
    ctx = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).float(),
                       v.reshape(n, t, n_heads, dv).float())
    return ctx.reshape(n, t, n_heads * dv).to(q.dtype)


def exp_mhsa_bwd_reference(q, k, v, key_mask, g, n_heads: int):
    """Plain PyTorch version of rows 6 and 8: (dq, dk, dv) in q's dtype,
    the probs recomputed as rows 5 and 7 compute them; g (N, T, H*Dv) in
    q's dtype. a is rounded to g's dtype for dv = a^T g, ds =
    (da - rowsum(da * a)) * a / sqrt(Dk) to k's dtype for dq = ds k and
    dk = ds^T q."""
    n, t, dk, dv = _check_sep(q, k, v, key_mask, n_heads)
    _check_grad(g, q, n, t, n_heads * dv)
    a, qh, kh = _sep_probs(q, k, key_mask, n_heads)
    gh = g.reshape(n, t, n_heads, dv).float()
    d_v = torch.einsum("bhqk,bqhd->bkhd", a.to(g.dtype).float(), gh)
    da = torch.einsum("bqhd,bkhd->bhqk", gh,
                      v.reshape(n, t, n_heads, dv).float())
    ds = (da - (da * a).sum(-1, keepdim=True)) * a * (1.0 / math.sqrt(dk))
    ds = ds.to(k.dtype).float()
    d_q = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    d_k = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return tuple(x.reshape(n, t, -1).to(q.dtype) for x in (d_q, d_k, d_v))


def _check_sep_launch(q, k, v, key_mask, *more):
    """What rows 5-8 need of their operands; returns the row strides of q,
    k and v (each (N, T, W) with contiguous lanes, rows a stride apart)."""
    kernels.check_operands(q, k, v, key_mask, *more, contiguous=False)
    for x in (key_mask, *more):
        if x is not None and not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")
    t = q.shape[1]
    lds = []
    for x in (q, k, v):
        ld = x.stride(1)
        if x.stride() != (t * ld, ld, 1):
            raise ValueError("q, k, v must have contiguous lanes and rows a "
                             f"stride apart; got strides {x.stride()}")
        lds.append(ld)
    return lds


# ---- rows 5-8: the launch plans ---------------------------------------------

SEP_REGIMES = ("resident", "mma", "wide")  # rows 6 and 8
SEP_FWD_REGIMES = ("rowwise", "mma", "tiled")  # rows 5 and 7
SEP_SHORT_T = 64  # longest T of the resident and row-wise regimes
SEP_MAX_HEAD = 64  # widest head of every regime but "wide" and "rowwise"
SEP_PER_SM = 3  # resident blocks an SM holds by registers (launch bounds)
# The forward past T = 64 on the tiled kernel: threads (one query each)
# and keys staged at once (csrc/mhsa_sep_fwd.cuh kTiledThreads,
# kTiledChunk). On an H100 at (64, 511), d_k 20, d_v 32, chunks of 128
# took 2.64 ms against 4.43 for 256 and 2.68 for 64, and two queries a
# thread 2.68 (PERF.md, PR 14).
SEP_TILED_THREADS, SEP_TILED_CHUNK = 128, 128


def sep_fwd_regime(t: int, dk: int, dv: int, itemsize: int) -> str:
    """The regime of rows 5 and 7 at (T, d_k, d_v) (``csrc/mhsa_sep_fwd.cuh``
    ``regime``): "mma" (tensor cores) past T = 64 in bf16 and "tiled" (CUDA
    cores) past it in f32, each with both widths up to 64; else "rowwise",
    the kernel rows 5 and 7 were first ported with."""
    if max(dk, dv) > SEP_MAX_HEAD or t <= SEP_SHORT_T:
        return "rowwise"
    return "mma" if itemsize == 2 else "tiled"


class SepFwdPlan(NamedTuple):
    """The regime of rows 5 and 7 (``SEP_FWD_REGIMES``) and its launch
    (``blockwise.Launch``; none row-wise)."""
    regime: str
    launch: blockwise.Launch | None = None

    def args(self) -> tuple:
        """The three ints the C entry points take: (tile, chunk, nbuf);
        zeros row-wise."""
        if self.launch is None:
            return (0,) * 3
        p = self.launch
        return (p.tile, p.chunk, p.nbuf)


def sep_tiled_smem(dk: int, dv: int) -> int:
    """Shared bytes of a tiled block: SEP_TILED_CHUNK keys of K and V at
    their compile-time widths and of the mask, f32 (``tiled_smem``)."""
    return 4 * SEP_TILED_CHUNK * (blockwise._width(dk)
                                  + blockwise._width(dv) + 1)


def sep_fwd_launch_plan(n: int, t: int, heads: int, dk: int, dv: int, dtype,
                        sms: int = 132) -> SepFwdPlan:
    """The regime and launch of rows 5 and 7 at (N, T, H, d_k, d_v) in
    ``dtype``. Tensor cores: row 9's forward layout at the larger width
    (``blockwise.mma_launch`` of kind "fwd": a block per (row, head) and
    tile of 128 or 64 queries, K, V and the mask in chunks over all T
    keys); tiled: a block of SEP_TILED_THREADS threads per (row, head),
    one query a thread, SEP_TILED_CHUNK keys staged at once; row-wise, no
    plan. A dtype other than float32 and bfloat16 raises TypeError."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    regime = sep_fwd_regime(t, dk, dv, itemsize)
    rows = n * heads
    if regime == "mma":
        tile = blockwise.mma_tile(rows, t, sms)
        return SepFwdPlan(regime, blockwise.mma_launch(
            "fwd", max(dk, dv), itemsize, tile, t, (rows, -(-t // tile))))
    if regime == "tiled":
        tile = SEP_TILED_THREADS
        return SepFwdPlan(regime, blockwise.Launch(
            "sep_fwd_tiled", tile, SEP_TILED_CHUNK, 1, sep_tiled_smem(dk, dv),
            (rows, -(-t // tile)), SEP_TILED_THREADS))
    return SepFwdPlan(regime)


def mhsa_sep_fwd(q, k, v, key_mask, n_heads: int):
    """Kernel rows 5 (key_mask None) and 7 on CUDA tensors: the context as
    exp_mhsa_reference, in the regime of ``sep_fwd_launch_plan``. q, k, v
    may be views of one projection. Raises for other devices."""
    n, t, dk, dv = _check_sep(q, k, v, key_mask, n_heads)
    lds = _check_sep_launch(q, k, v, key_mask)
    out = torch.empty((n, t, n_heads * dv), dtype=q.dtype, device=q.device)
    plan = sep_fwd_launch_plan(n, t, n_heads, dk, dv, q.dtype,
                               blockwise._sms(q.device))
    scratch, slots = None, 0
    if plan.regime == "rowwise":  # past shared memory: the global slots
        scratch, slots = kernels.scratch(
            "mhsa_sep", "mhsa_sep_fwd_scratch_floats", n * n_heads, q.device,
            t, dk, dv)
    kernels.call("mhsa" if key_mask is None else "mhsa_masked",
                 kernels.entry("mhsa_sep", "mhsa_sep_fwd", q.dtype), q.device,
                 *map(kernels.ptr, (q, k, v, key_mask, out, scratch)), n, t,
                 n_heads, dk, dv, *lds, SEP_FWD_REGIMES.index(plan.regime),
                 *plan.args(), slots, regime=plan.regime)
    return out


def sep_bwd_regime(t: int, dk: int, dv: int, itemsize: int) -> str:
    """The regime of rows 6 and 8 at (T, d_k, d_v) (``csrc/mhsa_sep_bwd.cuh``
    ``regime``): "resident" at T <= 64, "mma" (tensor cores) past it in
    bf16, each with both widths up to 64; else "wide"."""
    if max(dk, dv) > SEP_MAX_HEAD:
        return "wide"
    if t <= SEP_SHORT_T:
        return "resident"
    return "mma" if itemsize == 2 else "wide"


def sep_resident_plan(n: int, t: int, heads: int, d: int, itemsize: int,
                      sms: int):
    """The resident kernel's launch (``experimental_blanes.Plan``, row 16's
    layout at head width d): of four, two or one heads an item and two or
    one stage buffers, the plan that leaves room for the most blocks on an
    SM by shared memory, up to SEP_PER_SM, then the most heads, then two
    buffers; as many blocks as the SMs then hold, or one per item."""
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl

    best = None
    for g in (4, 2, 1):
        group = min(heads, g)
        for nbuf in (2, 1):
            smem = bl.smem_bytes("bwd", t, d, itemsize, group, t, nbuf)
            if smem <= kernels.MAX_SMEM:
                per_sm = min(SEP_PER_SM, bl.SM_SMEM // (smem + 1024))
                key = (per_sm, group, nbuf)
                if best is None or key > best[0]:
                    best = (key, smem)
    (per_sm, group, nbuf), smem = best
    items = n * -(-heads // group)
    return bl.Plan("bwd", group, t, nbuf, items, min(items, sms * per_sm),
                   smem)


class SepBwdPlan(NamedTuple):
    """The regime of rows 6 and 8 (``SEP_REGIMES``) and its launches: the
    resident kernel's (``experimental_blanes.Plan``), or the tensor-core
    query side's and key side's (``blockwise.Launch``)."""
    regime: str
    resident: NamedTuple | None = None
    query: blockwise.Launch | None = None
    key: blockwise.Launch | None = None

    def args(self) -> tuple:
        """The six ints the C entry points take: resident (heads, nbuf,
        blocks, 0, 0, 0); tensor cores (tile, chunk, nbuf) of the query
        side, then of the key side; wide zeros."""
        if self.regime == "resident":
            r = self.resident
            return (r.heads, r.nbuf, r.blocks, 0, 0, 0)
        if self.regime == "mma":
            return tuple(x for p in (self.query, self.key)
                         for x in (p.tile, p.chunk, p.nbuf))
        return (0,) * 6


def sep_bwd_launch_plan(n: int, t: int, heads: int, dk: int, dv: int, dtype,
                        sms: int = 132) -> SepBwdPlan:
    """The regime and launches of rows 6 and 8 at (N, T, H, d_k, d_v) in
    ``dtype``. Both designs stage every head at the larger width, so their
    layouts are those of the kernels they come from at that width:
    resident, row 16's (``sep_resident_plan``: up to four heads and two
    buffers a block, at most as many blocks as the card holds); tensor
    cores, rows 3-4's (``bwd_launch_plan``: a block per (row, head) and
    tile of 128 or 64 rows a side, the other side in chunks); wide, no
    plan. A dtype other than float32 and bfloat16 raises TypeError."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    d = max(dk, dv)
    regime = sep_bwd_regime(t, dk, dv, itemsize)
    if regime == "resident":
        return SepBwdPlan(regime, resident=sep_resident_plan(
            n, t, heads, d, itemsize, sms))
    if regime == "mma":
        query, key = _mma_sides(n, t, heads, d, itemsize, sms)
        return SepBwdPlan(regime, query=query, key=key)
    return SepBwdPlan(regime)


def mhsa_sep_bwd(q, k, v, key_mask, g, n_heads: int):
    """Kernel rows 6 (key_mask None) and 8 on CUDA tensors: (dq, dk, dv)
    as exp_mhsa_bwd_reference, in the regime of ``sep_bwd_launch_plan``.
    Raises for other devices."""
    n, t, dk, dv = _check_sep(q, k, v, key_mask, n_heads)
    _check_grad(g, q, n, t, n_heads * dv)
    lds = _check_sep_launch(q, k, v, key_mask, g)
    d_q, d_k = (torch.empty((n, t, n_heads * dk), dtype=q.dtype,
                            device=q.device) for _ in range(2))
    d_v = torch.empty((n, t, n_heads * dv), dtype=q.dtype, device=q.device)
    plan = sep_bwd_launch_plan(n, t, n_heads, dk, dv, q.dtype,
                               blockwise._sms(q.device))
    scratch, slots = None, 0
    if plan.regime == "mma":  # each (row, head, query)'s m, den and r
        scratch = torch.empty((3, n * n_heads, t), dtype=torch.float32,
                              device=q.device)
    elif plan.regime == "wide":  # past shared memory: the global slots
        scratch, slots = kernels.scratch(
            "mhsa_sep", "mhsa_sep_bwd_scratch_floats", n * n_heads, q.device,
            t, dk, dv)
    kernels.call("mhsa_bwd" if key_mask is None else "mhsa_bwd_masked",
                 kernels.entry("mhsa_sep", "mhsa_sep_bwd", q.dtype), q.device,
                 *map(kernels.ptr, (q, k, v, key_mask, g, d_q, d_k, d_v,
                                    scratch)), n, t, n_heads, dk, dv, *lds,
                 SEP_REGIMES.index(plan.regime), *plan.args(), slots,
                 regime=plan.regime)
    return d_q, d_k, d_v


class _ExpMhsa(torch.autograd.Function):
    """Rows 5/7 forward (saves q, k, v and the mask), rows 6/8 backward,
    which recomputes the probs; their plain versions for CPU tensors. The
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_heads):
        ctx.n_heads = n_heads
        ctx.save_for_backward(q, k, v, key_mask)
        fwd = exp_mhsa_reference if q.device.type == "cpu" else mhsa_sep_fwd
        return fwd(q, k, v, key_mask, n_heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, key_mask = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()  # as the JAX package casts it
        bwd = (exp_mhsa_bwd_reference if q.device.type == "cpu"
               else mhsa_sep_bwd)
        return (*bwd(q, k, v, key_mask, g, ctx.n_heads), None, None)


def _attend_sep(q, k, v, key_mask, n_heads):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _ExpMhsa.apply(q, k, v, key_mask, n_heads)
    if q.device.type == "cpu":
        return exp_mhsa_reference(q, k, v, key_mask, n_heads)
    return mhsa_sep_fwd(q, k, v, key_mask, n_heads)


def exp_mhsa(q, k, v, n_heads: int):
    """Exp-MHSA on separate q, k (N, T, H*Dk) and v (N, T, H*Dv). Returns
    the context (N, T, H*Dv), differentiable in q, k and v."""
    return _attend_sep(q, k, v, None, n_heads)


def exp_mhsa_masked(q, k, v, key_mask, n_heads: int):
    """Key-masked exp_mhsa; key_mask (N, T) float32 0/1 over keys. A row
    whose keys are all masked gives 0."""
    return _attend_sep(q, k, v, key_mask, n_heads)
