"""Key-blocked ("flash") exp-normalised MHSA for long sequences: two CUDA
kernels behind an autograd Function, and their plain PyTorch versions.

Replaces, in ``newsrecommendation_tpu/ops/pallas/blockwise.py``:
  - ``_fwd_call`` (``_flash_fwd_kernel``): online max and sum over key
    blocks; writes o (N, T, H*D) and the per-row m and den (N, T, H) f32
    -> ``csrc/flash_fwd.cu``, kernel "flash_fwd" (row 9);
  - ``_bwd_call`` (``_flash_bwd_kernel``): dq, dk and dv from o, m, den
    and delta = sum_d g * o -> ``csrc/flash_bwd.cu``, kernel "flash_bwd"
    (row 10).
``ops/attention.py`` sends a sequence here when it has at least
``kernel_config.flash_min_seq()`` keys (512 by default), as the JAX
package's dispatch does. The math is the exp-normalise of the other
attention kernels (max over all keys, mask after the exp, 1e-8 exp(-m)
in the denominator, a fully masked row gives 0); only the bf16 rounding
point differs: the un-normalised e against the running max meets v, so the
key block (JAX's ``_block_rows(t, block_kv)``) is part of the contract.

The kernels take three regimes, chosen by ``launch_plan`` from the dtype
and D: bf16 heads of up to 64 on tensor cores (a block a (row, head) and a
tile of queries or keys, the other side staged in chunks that never cross
a key block in the forward), f32 heads of up to 64 on CUDA cores (the
forward a tile of queries' scores over a chunk of 256 keys in registers,
split over 16 lanes; each side of the backward one own row a thread,
walking the other side in order), and heads past 64, of any width, in
either dtype on the wide kernels (``csrc/flash_wide.cuh``: a warp per
row, its lanes over D). The C side computes the same layout and refuses
a plan it does not take. Each launch counts under its variant and its
plan's regime.

q, k and v are (N, T, H*D) and may be views of one fused projection: their
lanes must be contiguous and their rows a common stride apart. A CPU tensor
takes the plain versions, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from newsrecommendation_tpu_torch.ops import kernels

_EPS = 1e-8
_NEG_BIG = -1e30
BLOCK_KV = 256  # the JAX package's default key block
MAX_HEAD = 64  # widest head of the tensor-core and CUDA-core kernels
WIDE_WARPS = 8  # rows (a warp each) of a wide kernel's block (D > MAX_HEAD)
MAX_CHUNK = 256  # rows of the other side staged at once (tensor cores)
# The CUDA-core (f32) kernels (csrc/flash.cuh): rows of the other side staged
# at once, and threads a block of the forward and of a backward side.
CORE_CHUNK = 256
CORE_FWD_THREADS, CORE_BWD_THREADS = 256, 128
SM_SMEM = 233472  # shared memory of one SM; a block takes 1 KB more
MAX_SMEM = 232448  # what one block may use (ops/kernels.py MAX_SMEM)
# Blocks of 256 threads an SM holds by registers: the forward and the
# query side are built for three (__launch_bounds__), the key side takes
# two (122 registers at D = 20). A plan with room for a third block beat
# two stage buffers at (128, 512) in bf16 on an H100: 0.99 against 1.05 ms
# forward, 2.16 against 2.31 backward (scripts/flash_variants.py plans).
RESIDENT = 3
KINDS = {"fwd": 0, "bwd_key": 1, "bwd_query": 2}
# The sides of rows 3-4's tensor-core backward stage what the flash
# backward's do; row 3's also a tile of its f32 probs (csrc/flash.cuh
# FlashKind).
QKV_KINDS = {"bwd_key_probs": 3, "bwd_query_probs": 4}


def kv_block(t: int, target: int = BLOCK_KV) -> int:
    """The JAX package's key block for a sequence of t keys: the largest
    divisor of t that is <= target and divisible by 8, else t itself."""
    b = min(t, target)
    while b >= 8:
        if t % b == 0 and b % 8 == 0:
            return b
        b -= 1
    return t


def uses_mma(d: int, itemsize: int) -> bool:
    """Whether the tensor-core kernels take (dtype, D): bf16 heads of up
    to MAX_HEAD (csrc/flash.cuh ``flash_mma``); f32 runs on CUDA cores."""
    return itemsize == 2 and d <= MAX_HEAD


def _width(d):
    """The kernels' compile-time width DM: the least of 8, 16, 24, 32, 64
    that holds D (csrc/flash.cuh ``flash_dm``)."""
    return next(w for w in (8, 16, 24, 32, 64) if d <= w)


def _row_bytes(d):
    """Bytes of a staged bf16 head row on tensor cores: DM padded to whole
    k-steps of 16, the row to an odd number of 16-byte units
    (``flash_row_elems``)."""
    rb = -(-_width(d) // 16) * 32
    return rb + 16 if (rb // 16) % 2 == 0 else rb


def _core_width(d):
    """The CUDA-core kernels' compile-time width: D itself at 8, 16, 20,
    24, 32 and 64, else the next of those (csrc/flash.cuh ``core_dm``)."""
    return next(w for w in (8, 16, 20, 24, 32, 64) if d <= w)


def core_row_floats(d):
    """Floats between two staged f32 rows on CUDA cores: the width, or 4
    more where its float4s are an even count (``core_row_floats``)."""
    w = _core_width(d)
    return w if (w // 4) % 2 else w + 4


def core_rows(d: int) -> int:
    """Queries a CUDA-core forward thread holds: 4 up to a width of 24, 2
    past it (csrc/flash.cuh ``core_fwd_rows``)."""
    return 4 if _core_width(d) <= 24 else 2


def core_tile(kind: str, d: int) -> int:
    """The tile the CUDA-core kernels take for ``kind`` at D (csrc/flash.cuh
    ``core_tile_ok``): the forward 16 query groups of core_rows(d)
    queries, 16 key lanes a group (CORE_FWD_THREADS threads); a backward
    side 128 own rows, one a thread."""
    return 16 * core_rows(d) if kind == "fwd" else CORE_BWD_THREADS


def core_resident(kind: str, d: int) -> int:
    """Blocks of a CUDA-core kernel an SM holds by the registers its
    ``__launch_bounds__`` allow (flash_fwd.cu; flash_bwd.cu
    ``core_bwd_blocks``)."""
    w = _core_width(d)
    if kind == "fwd":
        return 1
    return 4 if w <= 24 else 3 if w <= 32 else 1


def smem_bytes(kind: str, d: int, itemsize: int, tile: int, chunk: int,
               nbuf: int) -> int:
    """Shared bytes of one block of ``kind`` (csrc/flash.cuh
    ``flash_layout``). On tensor cores: the block's own rows (fwd: Q; the
    backward's key side: K, V; its query side: Q, g), then ``nbuf`` stage
    buffers of ``chunk`` rows of the other side's two operands and its
    per-row floats (fwd and query side: the mask; key side: m, den, 1/den,
    delta); rows 3's sides ("bwd_key_probs", "bwd_query_probs") also the
    f32 probs of the chunk's rows over the tile's, rows 4 floats longer
    than they are wide. On CUDA cores f32 rows of ``core_row_floats``: the
    forward's own Q, then ``nbuf`` buffers of ``chunk`` rows of two
    operands and one per-row float (four on the key side); the backward
    holds its own rows in registers. The wide kernels (D > MAX_HEAD)
    stage nothing."""
    if d > MAX_HEAD:
        return 0
    key = kind in ("bwd_key", "bwd_key_probs")
    if not uses_mma(d, itemsize):
        rs = core_row_floats(d)
        own = tile * rs if kind == "fwd" else 0
        return 4 * (own + nbuf * (2 * chunk * rs + (4 if key else 1) * chunk))
    floats = 4 if key else 1
    rb = _row_bytes(d)
    own = (1 if kind == "fwd" else 2) * tile * rb
    probs = {"bwd_key_probs": chunk * (tile + 4),
             "bwd_query_probs": tile * (chunk + 4)}.get(kind, 0)
    return own + nbuf * (2 * chunk * rb + -(-4 * floats * chunk // 16) * 16
                         + 4 * probs)


def key_walk(t: int, block: int, chunk: int) -> list:
    """The forward's tasks over key blocks of ``block`` keys (csrc/flash.cuh
    ``flash_task``): (first key, keys, max walk, exp walk) each. A block of
    up to ``chunk`` keys is one task taking both walks over its staged
    keys; a longer one is its chunks for the max walk, then the same chunks
    again for the exp walk, so each e is formed against its block's whole
    max. No task crosses a block edge."""
    nc = -(-block // chunk)
    tasks = []
    for b0 in range(0, t, block):
        chunks = [(b0 + c * chunk, min(chunk, block - c * chunk))
                  for c in range(nc)]
        if nc == 1:
            tasks.append((*chunks[0], True, True))
        else:
            tasks += [(*c, True, False) for c in chunks]
            tasks += [(*c, False, True) for c in chunks]
    return tasks


class Launch(NamedTuple):
    """One kernel launch: a block takes one (row, head) and ``tile`` of its
    own rows (queries; keys on the backward's key side) with ``threads``
    threads, and walks the other side ``chunk`` rows at a time through
    ``nbuf`` stage buffers; ``smem`` bytes a block; ``grid`` (N*H, row
    tiles)."""
    kind: str
    tile: int
    chunk: int
    nbuf: int
    smem: int
    grid: tuple
    threads: int


class FlashPlan(NamedTuple):
    """The regime ("mma": tensor cores, "cuda_core", "wide") and the
    launches of rows 9 (fwd) and 10 (bwd_key, then bwd_query)."""
    regime: str
    fwd: Launch
    bwd_key: Launch
    bwd_query: Launch


def mma_tile(rows: int, t: int, sms: int) -> int:
    """Own rows of a tensor-core block: 128, or 64 when 128 leaves fewer
    than two blocks per SM over ``rows`` (row, head) items of t rows."""
    return 128 if rows * -(-t // 128) >= 2 * sms else 64


def mma_launch(kind: str, d: int, itemsize: int, tile: int,
               rows_walked: int, grid: tuple) -> Launch:
    """The tensor-core launch of ``kind`` with ``tile`` own rows that walks
    ``rows_walked`` rows of the other side: chunks of up to MAX_CHUNK rows
    (rounded up to 16) or halves of that, one or two buffers; the plan
    that leaves room for the most blocks on an SM by shared memory, up to
    RESIDENT, then the largest chunk (fewest copies), then two buffers.
    Raises NotImplementedError when no chunk fits a block."""
    chunk = min(MAX_CHUNK, -(-rows_walked // 16) * 16)
    fits = []
    while chunk >= 16:
        for nbuf in (2, 1):
            smem = smem_bytes(kind, d, itemsize, tile, chunk, nbuf)
            if smem <= MAX_SMEM:
                resident = min(RESIDENT, SM_SMEM // (smem + 1024))
                fits.append(((resident, chunk, nbuf), smem))
        chunk = chunk // 32 * 16
    if not fits:
        raise NotImplementedError(
            f"D={d}: the {kind} kernel needs more than {MAX_SMEM} bytes of "
            "shared memory per block")
    (_, chunk, nbuf), smem = max(fits)
    return Launch(kind, tile, chunk, nbuf, smem, grid, 2 * tile)


def core_launch(kind: str, d: int, t: int, rows: int) -> Launch:
    """The CUDA-core launch of ``kind`` at D over ``rows`` (row, head)
    items of t rows: core_tile's own rows a block, chunks of CORE_CHUNK
    rows of the other side, two buffers where they leave room for the
    blocks its registers allow on an SM (core_resident), else one."""
    tile = core_tile(kind, d)
    for nbuf in (2, 1):
        smem = smem_bytes(kind, d, 4, tile, CORE_CHUNK, nbuf)
        if nbuf == 1 or (smem <= MAX_SMEM and SM_SMEM // (smem + 1024)
                         >= core_resident(kind, d)):
            break
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"D={d}: the {kind} kernel needs more than {MAX_SMEM} bytes of "
            "shared memory per block")
    threads = CORE_FWD_THREADS if kind == "fwd" else CORE_BWD_THREADS
    return Launch(kind, tile, CORE_CHUNK, nbuf, smem, (rows, -(-t // tile)),
                  threads)


def launch_plan(n: int, t: int, heads: int, d: int, dtype,
                block_kv: int = BLOCK_KV, sms: int = 132) -> FlashPlan:
    """The launches of rows 9-10 at (N, T, H, D) in ``dtype`` (float32 or
    bfloat16). On tensor cores: tiles of 128 rows (64 when that leaves
    fewer than two blocks per SM); chunks of the other side of up to
    MAX_CHUNK rows (in the forward up to the key block, rounded up to 16)
    or halves of that; of those chunks and one or two buffers, the plan
    that leaves room for the most blocks on an SM by shared memory, up to
    RESIDENT, then the largest chunk (fewest copies), then two buffers. On
    CUDA cores core_launch's plan of each kind; past MAX_HEAD the wide
    kernels', WIDE_WARPS rows a block and nothing staged. Raises
    NotImplementedError for a plan that fits no block."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    rows = n * heads
    if d > MAX_HEAD:
        grid = (rows, -(-t // WIDE_WARPS))
        return FlashPlan("wide", *(
            Launch(kind, WIDE_WARPS, 0, 0, 0, grid, 32 * WIDE_WARPS)
            for kind in KINDS))
    if not uses_mma(d, itemsize):
        return FlashPlan("cuda_core", *(core_launch(kind, d, t, rows)
                                        for kind in KINDS))
    tile = mma_tile(rows, t, sms)
    grid = (rows, -(-t // tile))

    def one(kind, rows_walked):
        return mma_launch(kind, d, itemsize, tile, rows_walked, grid)

    return FlashPlan("mma", one("fwd", kv_block(t, block_kv)),
                     one("bwd_key", t), one("bwd_query", t))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, k, v, key_mask, n_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (N, T, H*D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, t, hd = q.shape
    if n_heads < 1 or hd % n_heads != 0:
        raise ValueError(f"width {hd} is not n_heads({n_heads}) * D")
    if key_mask is not None and key_mask.shape != (n, t):
        raise ValueError(f"key_mask must be ({n}, {t}), "
                         f"got {tuple(key_mask.shape)}")
    return n, t, hd // n_heads


def _heads(x, n_heads):
    n, t, hd = x.shape
    return x.reshape(n, t, n_heads, hd // n_heads)


def flash_fwd_reference(q, k, v, key_mask, n_heads: int,
                        block_kv: int = BLOCK_KV):
    """Plain PyTorch version of row 9, block for block: returns (o in q's
    dtype, m, den (N, T, H) f32). key_mask may be None."""
    n, t, d = _check(q, k, v, key_mask, n_heads)
    bkv = kv_block(t, block_kv)
    inv = 1.0 / math.sqrt(d)
    qh, kh = _heads(q, n_heads).float(), _heads(k, n_heads).float()
    vh = _heads(v, n_heads)
    m = q.new_full((n, n_heads, t), _NEG_BIG, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((n, n_heads, t, d), dtype=torch.float32)
    for b0 in range(0, t, bkv):
        s = torch.einsum("nqhd,nkhd->nhqk", qh, kh[:, b0:b0 + bkv]) * inv
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        if key_mask is not None:
            e = e * key_mask[:, None, None, b0:b0 + bkv].float()
        l = l * scale + e.sum(-1)
        pv = torch.einsum("nhqk,nkhd->nhqd", e.to(v.dtype).float(),
                          vh[:, b0:b0 + bkv].float())
        acc = acc * scale[..., None] + pv
        m = m_new
    den = l + _EPS * torch.exp(-m)
    o = torch.where(den[..., None] > 0, acc / den[..., None],
                    torch.zeros_like(acc))
    return (o.permute(0, 2, 1, 3).reshape(n, t, n_heads * d).to(q.dtype),
            m.permute(0, 2, 1).contiguous(), den.permute(0, 2, 1).contiguous())


def flash_bwd_reference(q, k, v, key_mask, g, m, den, delta, n_heads: int,
                        block_kv: int = BLOCK_KV):
    """Plain PyTorch version of row 10: (dq, dk, dv) in q's dtype from the
    forward's m and den (N, T, H) and delta = sum_d g * o (N, T, H), all
    f32; g in q's dtype. a rounded to g's dtype for dv, ds rounded to k's
    dtype before dq and dk, dq summed over key blocks in f32."""
    n, t, d = _check(q, k, v, key_mask, n_heads)
    bkv = kv_block(t, block_kv)
    inv = 1.0 / math.sqrt(d)
    qh, kh, vh = (_heads(x, n_heads).float() for x in (q, k, v))
    gh = _heads(g, n_heads)
    mt, dent, deltat = (x.permute(0, 2, 1)[..., None] for x in (m, den,
                                                                 delta))
    dq = torch.zeros_like(qh)
    dks, dvs = [], []
    for b0 in range(0, t, bkv):
        kb, vb = kh[:, b0:b0 + bkv], vh[:, b0:b0 + bkv]
        s = torch.einsum("nqhd,nkhd->nhqk", qh, kb) * inv
        e = torch.exp(s - mt)
        if key_mask is not None:
            e = e * key_mask[:, None, None, b0:b0 + bkv].float()
        a = torch.where(dent > 0, e / dent, torch.zeros_like(e))
        dvs.append(torch.einsum("nhqk,nqhd->nkhd", a.to(g.dtype).float(),
                                gh.float()))
        da = torch.einsum("nqhd,nkhd->nhqk", gh.float(), vb)
        ds = ((da - deltat) * a * inv).to(k.dtype).float()
        dq = dq + torch.einsum("nhqk,nkhd->nqhd", ds, kb)
        dks.append(torch.einsum("nhqk,nqhd->nkhd", ds, qh))
    return tuple(x.reshape(n, t, n_heads * d).to(q.dtype)
                 for x in (dq, torch.cat(dks, 1), torch.cat(dvs, 1)))


def delta_of(g, o, n_heads: int):
    """delta = sum_d g * o per (row, query, head) in f32, as the JAX
    package computes it outside its backward kernel."""
    return (_heads(g.float(), n_heads) * _heads(o.float(), n_heads)).sum(-1)


def _check_launch(q, k, v, key_mask, d, *more):
    """What the flash kernels need; returns the row stride of q, k, v."""
    kernels.check_operands(q, k, v, key_mask, *more, contiguous=False)
    for x in (key_mask, *more):
        if x is not None and not x.is_contiguous():
            raise ValueError("operands must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask is not None and key_mask.dtype != torch.float32:
        raise TypeError(f"key_mask must be float32, got {key_mask.dtype}")
    n, t, _ = q.shape
    ld = q.stride(1)
    for x in (q, k, v):
        if x.stride() != (t * ld, ld, 1):
            raise ValueError("q, k, v must have contiguous lanes and one "
                             f"row stride; got strides {x.stride()} and "
                             f"{q.stride()}")
    return ld


def flash_fwd(q, k, v, key_mask, n_heads: int, block_kv: int = BLOCK_KV):
    """Kernel row 9 on CUDA tensors: (o, m, den) as flash_fwd_reference.
    Raises for other devices."""
    n, t, d = _check(q, k, v, key_mask, n_heads)
    ld = _check_launch(q, k, v, key_mask, d)
    plan = launch_plan(n, t, n_heads, d, q.dtype, block_kv, _sms(q.device))
    p = plan.fwd
    o = torch.empty((n, t, n_heads * d), dtype=q.dtype, device=q.device)
    m = torch.empty((n, t, n_heads), dtype=torch.float32, device=q.device)
    den = torch.empty_like(m)
    kernels.call("flash" if key_mask is None else "flash_masked",
                 kernels.entry("flash_fwd", "flash_fwd", q.dtype), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kernels.ptr(key_mask), o.data_ptr(), m.data_ptr(),
                 den.data_ptr(), n, t, n_heads, d, ld, kv_block(t, block_kv),
                 p.tile, p.chunk, p.nbuf,
                 regime=plan.regime)
    return o, m, den


def flash_bwd(q, k, v, key_mask, g, m, den, delta, n_heads: int):
    """Kernel row 10 on CUDA tensors: (dq, dk, dv) as flash_bwd_reference
    (whose result does not depend on the key block). Raises for other
    devices."""
    n, t, d = _check(q, k, v, key_mask, n_heads)
    if g.shape != (n, t, n_heads * d) or g.dtype != q.dtype:
        raise ValueError(f"g must be {q.dtype} ({n}, {t}, {n_heads * d}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    for name, x in (("m", m), ("den", den), ("delta", delta)):
        if x.shape != (n, t, n_heads) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({n}, {t}, {n_heads}),"
                             f" got {x.dtype} {tuple(x.shape)}")
    ld = _check_launch(q, k, v, key_mask, d, g, m, den, delta)
    plan = launch_plan(n, t, n_heads, d, q.dtype, sms=_sms(q.device))
    kp, qp = plan.bwd_key, plan.bwd_query
    dq, dk, dv = (torch.empty((n, t, n_heads * d), dtype=q.dtype,
                              device=q.device) for _ in range(3))
    kernels.call("flash_bwd" if key_mask is None else "flash_bwd_masked",
                 kernels.entry("flash_bwd", "flash_bwd", q.dtype), q.device,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kernels.ptr(key_mask), g.data_ptr(), m.data_ptr(),
                 den.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), n, t, n_heads, d, ld,
                 kp.tile, kp.chunk, kp.nbuf, qp.tile, qp.chunk, qp.nbuf,
                 regime=plan.regime)
    return dq, dk, dv


class _FlashExpMhsa(torch.autograd.Function):
    """Row 9 forward (saves q, k, v, the mask, o, m and den; no probs), row
    10 backward; their plain versions for CPU tensors. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, n_heads, block_kv):
        fwd = flash_fwd_reference if q.device.type == "cpu" else flash_fwd
        o, m, den = fwd(q, k, v, key_mask, n_heads, block_kv)
        ctx.save_for_backward(q, k, v, key_mask, o, m, den)
        ctx.n_heads, ctx.block_kv = n_heads, block_kv
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, key_mask, o, m, den = ctx.saved_tensors
        delta = delta_of(g, o, ctx.n_heads)
        g = g.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            grads = flash_bwd_reference(q, k, v, key_mask, g, m, den, delta,
                                        ctx.n_heads, ctx.block_kv)
        else:
            grads = flash_bwd(q, k, v, key_mask, g, m, den, delta,
                              ctx.n_heads)
        return (*grads, None, None, None)


def _attend(q, k, v, key_mask, n_heads, block_kv):
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashExpMhsa.apply(q, k, v, key_mask, n_heads, block_kv)
    fwd = flash_fwd_reference if q.device.type == "cpu" else flash_fwd
    return fwd(q, k, v, key_mask, n_heads, block_kv)[0]


def flash_exp_mhsa(q, k, v, n_heads: int, block_kv: int = BLOCK_KV):
    """Key-blocked exp-MHSA over q, k, v (N, T, H*D); returns (N, T, H*D),
    differentiable in q, k and v."""
    return _attend(q, k, v, None, n_heads, block_kv)


def flash_exp_mhsa_masked(q, k, v, key_mask, n_heads: int,
                          block_kv: int = BLOCK_KV):
    """Key-masked flash_exp_mhsa; key_mask (N, T) float32 0/1 over keys. A
    row whose keys are all masked gives 0."""
    return _attend(q, k, v, key_mask, n_heads, block_kv)
