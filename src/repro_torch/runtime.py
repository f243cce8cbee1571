"""Device resolution for the port's entry points.

The port runs on the CUDA card. An entry point given no device uses
``cuda`` and raises when there is none; the CPU is used only when the
caller asks for it (``device="cpu"``), as the tests do. There is no
switch that prefers or avoids the kernels: a kernel wrapper chooses by the
device of the tensor it is given (see ``repro_torch.kernels``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; an explicit device is checked.
    Raises ``RuntimeError`` when CUDA is asked for (or implied) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
