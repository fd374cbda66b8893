"""The device every entry point of the port defaults to.

Entry points (``FmmSolver.build``, ``particles``, ``plan_from_numpy``)
take ``device=None`` to mean the CUDA card, which must exist: there is no
silent fall-back to the CPU. Pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import torch

from .errors import DeviceUnavailableError


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA card (raises
    ``DeviceUnavailableError`` when the process has none); otherwise the
    device asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "the port runs on the CUDA card by default and this process "
            "has none; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
