"""Rotary position embeddings: default-theta tables + rotate-half application.

Counterpart of mistralrs_tpu/ops/rope.py (`RopeTable`,
`compute_rope_table`, `apply_rope`). Tables are computed once in float64
numpy and kept as f32 [max_pos, rot/2]; a step gathers rows by position.
The llama3 and longrope scalings are later work and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeTable:
    """Precomputed cos/sin tables, [max_pos, rot_dim//2] each (f32)."""

    cos: torch.Tensor
    sin: torch.Tensor
    rot_dim: int  # number of head dims rotated

    def gather(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """positions [...] int -> (cos, sin) each [..., rot_dim//2]."""
        return self.cos[positions], self.sin[positions]

    def to(self, device) -> "RopeTable":
        return RopeTable(self.cos.to(device), self.sin.to(device), self.rot_dim)


def _default_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)


def compute_rope_table(
    head_dim: int,
    max_pos: int,
    theta: float = 10000.0,
    rope_scaling: dict[str, Any] | None = None,
    partial_rotary_factor: float = 1.0,
    device="cuda",
) -> RopeTable:
    """f32 cos/sin tables for the default rope (and "linear" scaling)."""
    rot_dim = int(head_dim * partial_rotary_factor)
    rot_dim -= rot_dim % 2
    kind = None
    if rope_scaling:
        kind = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if kind not in (None, "default", "linear"):
        raise NotImplementedError(f"rope scaling {kind!r} is not ported yet")
    inv_freq = _default_inv_freq(rot_dim, theta)
    t = np.arange(max_pos, dtype=np.float64)
    if kind == "linear":
        t = t / rope_scaling["factor"]
    freqs = np.outer(t, inv_freq)
    return RopeTable(
        torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
        torch.tensor(np.sin(freqs), dtype=torch.float32, device=device),
        rot_dim,
    )


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """Rotate-half rotary embedding. x [..., T, H, D]; cos/sin [..., T, rot/2]
    broadcast over heads. Computed in f32, returned in x's dtype."""
    if rot_dim < x.shape[-1]:
        x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    else:
        x_rot, x_pass = x, None
    xf = x_rot.to(torch.float32)
    half = rot_dim // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if x_pass is not None:
        out = torch.cat([out, x_pass], dim=-1)
    return out
