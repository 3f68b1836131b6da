"""Normalization and activation ops.

Counterpart of mistralrs_tpu/ops/layers.py (`rms_norm`, `silu`,
`gelu_tanh`, `swiglu`, `softcap`).
Norms accumulate in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, *,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with f32 accumulation (offset=1.0: Gemma's (1 + w) form)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    # a bf16 weight is promoted to f32 inside the multiply (exact)
    w = weight if offset == 0.0 else weight.to(torch.float32) + offset
    return (normed * w).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu (Gemma's gelu_pytorch_tanh)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "swish": silu, "gelu_new": gelu_tanh, "gelu_tanh": gelu_tanh,
               "gelu_pytorch_tanh": gelu_tanh}


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine: silu(gate) * up (llama/mistral MLPs)."""
    return silu(gate) * up


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
