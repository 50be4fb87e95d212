"""Where an entry point runs when its input is not yet a tensor.

The port runs on the card: ``device=None`` means ``"cuda"``, and without a
card such a call raises instead of running on the CPU. The CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do. Functions
that take tensors follow their tensors' device and do not come here.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; None is the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: obia_tpu_torch runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
