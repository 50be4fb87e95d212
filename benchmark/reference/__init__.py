"""The plain reference that decides ``correct``: plain torch and numpy, no
kernel of the program and nothing of ``obia_tpu_torch`` imported.

Every function takes a :class:`Precision`: :data:`REFERENCE` is the
configuration's own (float32 data and arithmetic, float64 sums), and
:data:`CONTROL` the nearest one below it (bfloat16 data and arithmetic,
float32 sums), the control that has to come out not correct.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Precision:
    """``ft``: the dtype of pixel data and per-pixel arithmetic;
    ``acc``: the dtype that sums and moments accumulate in."""
    ft: torch.dtype
    acc: torch.dtype


REFERENCE = Precision(torch.float32, torch.float64)
CONTROL = Precision(torch.bfloat16, torch.float32)
