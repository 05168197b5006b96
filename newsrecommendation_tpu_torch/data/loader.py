"""History and candidate index helpers shared by serving and (later) the
training loader."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def trans_to_nindex(nids: List[str], news_index: Dict[str, int]) -> List[int]:
    """doc ids -> 1-based indices, 0 for unknown (reference dataset.py:14-15)."""
    return [news_index.get(i, 0) for i in nids]


def pad_to_fix_len(x: List[int], fix_length: int, padding_front: bool = True,
                   padding_value: int = 0):
    """Reference dataset.py:17-24: keep the LAST fix_length entries; front-pad
    by default. Returns (padded list, float32 mask)."""
    if padding_front:
        pad_x = [padding_value] * (fix_length - len(x)) + x[-fix_length:]
        mask = [0] * (fix_length - len(x)) + [1] * min(fix_length, len(x))
    else:
        pad_x = x[-fix_length:] + [padding_value] * (fix_length - len(x))
        mask = [1] * min(fix_length, len(x)) + [0] * (fix_length - len(x))
    return pad_x, np.asarray(mask, dtype=np.float32)
