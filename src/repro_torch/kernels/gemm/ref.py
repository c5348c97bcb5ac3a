"""Plain PyTorch version of the GEMM kernel — the port of the JAX
package's ``kernels/gemm/ref.py``."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """C = A @ B with f32 accumulation (the kernel's numerics contract).
    On a CUDA tensor this is a float32 ``torch.matmul`` (TF32 stays off,
    ``repro_torch.device.resolve_device``)."""
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(out_dtype or a.dtype)
