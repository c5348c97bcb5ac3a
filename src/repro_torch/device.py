"""Device resolution for every entry point of the port.

The port runs on a CUDA card.  ``resolve_device()`` returns that card,
or raises when there is none: nothing in the port drops to the CPU on
its own.  The CPU is used only when a caller passes ``device="cpu"``
(the tests do, to run the kernels' plain versions).

Every entry point resolves its device here, so this is also where the
float32 matmul precision is pinned: TF32 is switched off for matmuls
and for cuDNN, so the float32 unembed and the float32 model variant
compute in full float32 on the card, as they do on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"``; raises when a CUDA device
    is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor in a nested dict (None if empty)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = device_of(v)
            if d is not None:
                return d
    return None
