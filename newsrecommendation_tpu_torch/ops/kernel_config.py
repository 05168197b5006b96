"""Process-wide switches of the attention kernels: the counterpart of
``newsrecommendation_tpu/ops/pallas/config.py``, under its names and with
its defaults.

The switches are read when a forward runs (the JAX package reads them when
a step is traced). ``pallas_mode`` has no counterpart: a tensor's device
decides between a kernel (CUDA) and its plain version (CPU).
"""

from __future__ import annotations

_BWD_RESIDUALS = "probs"  # "probs" | "recompute"
_FLASH_MIN_SEQ = 512
_FUSED_TAIL = "auto"  # "auto" | "on" | "off"
_ATTN_IO = "3d"  # "3d" | "2d"
_ATTN_LAYOUT = "headloop"  # "headloop" | "blanes"


def set_bwd_residuals(mode: str) -> None:
    """What the fused-qkv attention saves for its backward: "probs" (the
    forward writes the f32 probs; kernel rows 2 and 3) or "recompute" (the
    backward recomputes them from qkv; rows 1 and 4). Both give the same
    gradients."""
    global _BWD_RESIDUALS
    if mode not in ("recompute", "probs"):
        raise ValueError(f"unknown bwd_residuals mode {mode!r}")
    _BWD_RESIDUALS = mode


def bwd_residuals() -> str:
    return _BWD_RESIDUALS


def set_flash_min_seq(t: int) -> None:
    """Sequences of at least ``t`` keys go to the key-blocked flash kernels
    (rows 9-10); shorter ones to the fused-qkv kernels (rows 1-4)."""
    global _FLASH_MIN_SEQ
    if t < 1:
        raise ValueError(f"flash_min_seq must be >= 1, got {t}")
    _FLASH_MIN_SEQ = t


def flash_min_seq() -> int:
    return _FLASH_MIN_SEQ


def set_fused_tail(mode) -> None:
    """"on" (or True): each NRMS encoder tail, MHSA -> dropout -> pooling,
    runs as one kernel (rows 13-14). "off" (or False) and "auto" compose it
    from the attention kernels: the JAX package's "auto" fuses only in its
    Pallas interpret mode, which the port does not have."""
    global _FUSED_TAIL
    if isinstance(mode, bool):
        mode = "on" if mode else "off"
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_tail mode {mode!r}")
    _FUSED_TAIL = mode


def fused_tail_enabled(n_heads: int | None = None) -> bool:
    """True for "on" only (``n_heads`` is taken, as the JAX package's
    getter takes it, and not read)."""
    return _FUSED_TAIL == "on"


def set_attention_io(mode: str) -> None:
    """How the unmasked fused-qkv attention takes the projection: "3d"
    (an (N, T, 3HD) view; rows 1-4) or "2d" (the (N*T, 3HD) product as it
    is; rows 11-12). Masked attention keeps the 3-D kernels."""
    global _ATTN_IO
    if mode not in ("3d", "2d"):
        raise ValueError(f"unknown attention io {mode!r}")
    _ATTN_IO = mode


def attention_io() -> str:
    return _ATTN_IO


def set_attention_layout(layout: str) -> None:
    """How the fused-qkv attention below flash_min_seq keys maps its work:
    "headloop" (rows 1-4, or 11-12 with attention_io "2d") or "blanes"
    (the batch-in-lanes kernels, rows 15-16, masked and unmasked, whatever
    attention_io says)."""
    global _ATTN_LAYOUT
    if layout not in ("headloop", "blanes"):
        raise ValueError(f"unknown attention layout {layout!r}")
    _ATTN_LAYOUT = layout


def attention_layout() -> str:
    return _ATTN_LAYOUT


def apply(cfg) -> None:
    """Set the switches a Config carries, as the JAX package's CLI does
    before it builds a step (cli.py: set_bwd_residuals(cfg.bwd_residuals)
    and its siblings), so that a Config alone picks the kernels. The train
    step's builder and ``Recommender.from_state`` call it; the switches are
    process-wide, so the step built last decides."""
    set_bwd_residuals(cfg.bwd_residuals)
    set_fused_tail(cfg.fused_tail)
    set_attention_layout(cfg.attention_layout)
