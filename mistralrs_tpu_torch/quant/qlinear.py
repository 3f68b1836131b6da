"""`Linear`: the polymorphic (possibly quantized) linear layer.

Counterpart of mistralrs_tpu/quant/qlinear.py. Each kind's tensors live in
`data`; `kind`, `shape` and `meta` select the forward registered for the
kind with `register_kind`.

Weight convention: logical shape is (in_features, out_features) and the
forward is ``y = x @ W (+ b)``, the transpose of torch's nn.Linear (out, in),
so the packed GGUF layouts keep `out` as their last (contiguous) axis.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Linear:
    kind: str
    shape: tuple[int, int]  # (in, out)
    data: dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-kind layout constant (q6k chunk span, rq8 group size)
    meta: Any = None
    # activation route of the packed GEMVs (ops/quant_matmul.py): True =
    # x quantized to int8 per block (K1, K2, K3, K9), False = x kept in its
    # dtype (K5, K8, K9b, K4); set on every packed Linear by TextPipeline
    # from PipelineConfig.int8_activations. A site that rebuilds a Linear
    # carries it with dataclasses.replace.
    int8_act: bool = True

    @property
    def in_features(self) -> int:
        return self.shape[0]

    @property
    def out_features(self) -> int:
        return self.shape[1]


_FORWARDS: dict[str, Callable[[Linear, torch.Tensor], torch.Tensor]] = {}


def register_kind(kind: str):
    def deco(fn):
        _FORWARDS[kind] = fn
        return fn

    return deco


# the module whose import registers each family of kinds ("gptq" for gptq_4)
_KIND_MODULES = {"gguf": "mistralrs_tpu_torch.quant.gguf_linear",
                 "gptq": "mistralrs_tpu_torch.quant.gptq",
                 "hqq": "mistralrs_tpu_torch.quant.hqq"}


def linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+b). x: [..., in] -> [..., out]. A Linear with an
    `in_perm` (GPTQ act-order rows sorted at load) takes x gathered by it."""
    family = lin.kind.split("_")[0]
    if lin.kind not in _FORWARDS and family in _KIND_MODULES:
        importlib.import_module(_KIND_MODULES[family])  # registers the family's kinds
    in_perm = lin.data.get("in_perm")
    if in_perm is not None:
        x = torch.index_select(x, -1, in_perm)
    return _FORWARDS[lin.kind](lin, x)


@register_kind("dense")
def _dense_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, lin.data["w"].to(x.dtype))
    b = lin.data.get("b")
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def make_dense(w: torch.Tensor, b: torch.Tensor | None = None) -> Linear:
    """w: (in, out)."""
    data = {"w": w}
    if b is not None:
        data["b"] = b
    return Linear(kind="dense", shape=(int(w.shape[0]), int(w.shape[1])), data=data)
