"""ISQ, in-situ quantization of safetensors weights at load time.

Counterpart of mistralrs_tpu/quant/isq.py: the ISQ type names the reference
accepts (`parse_isq`, GGML types and HQQ1-8), the per-layer topology read
from YAML ranges (`Topology`) and the shape rule (`quantizable`). The
quantizers are quant/kquants.py's (numpy on the host) and quant/hqq.py's;
models/loader.py applies them.
"""

from __future__ import annotations

from mistralrs_tpu_torch.gguf.reader import GGML_BLOCK_INFO, GGMLType
from mistralrs_tpu_torch.quant.hqq import HqqType

# the reference's accepted spellings (parse_isq_value)
_ISQ_NAMES: dict[str, GGMLType] = {
    "Q4_0": GGMLType.Q4_0,
    "Q4_1": GGMLType.Q4_1,
    "Q5_0": GGMLType.Q5_0,
    "Q5_1": GGMLType.Q5_1,
    "Q8_0": GGMLType.Q8_0,
    "Q2K": GGMLType.Q2_K,
    "Q3K": GGMLType.Q3_K,
    "Q4K": GGMLType.Q4_K,
    "Q5K": GGMLType.Q5_K,
    "Q6K": GGMLType.Q6_K,
    "Q8K": GGMLType.Q8_K,
    "Q2_K": GGMLType.Q2_K,
    "Q3_K": GGMLType.Q3_K,
    "Q4_K": GGMLType.Q4_K,
    "Q5_K": GGMLType.Q5_K,
    "Q6_K": GGMLType.Q6_K,
    "Q8_K": GGMLType.Q8_K,
}

# the formats there is a quantizer for (kquants.QUANTIZERS)
SUPPORTED_ISQ = {
    GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
    GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
}


def parse_isq(value: str):
    """An ISQ name -> GGMLType or HqqType. Unknown names, and known ones
    without a quantizer (Q8K), raise ValueError."""
    v = value.strip().upper()
    if v.startswith("HQQ"):
        bits = int(v[3:])
        if bits not in (1, 2, 3, 4, 8):
            raise ValueError(f"HQQ bits must be 1/2/3/4/8, got {value!r}")
        return HqqType(bits)
    if v not in _ISQ_NAMES:
        raise ValueError(f"unknown ISQ type {value!r}; supported: {sorted(_ISQ_NAMES)} + HQQ1-8")
    g = _ISQ_NAMES[v]
    if g not in SUPPORTED_ISQ:
        raise ValueError(f"ISQ {value!r} parsed but no quantizer implemented yet "
                         f"(have: {sorted(t.name for t in SUPPORTED_ISQ)})")
    return g


class Topology:
    """Per-layer ISQ assignment from YAML ranges (the reference's
    topology/mod.rs).

    YAML shape:
        0-8:
          isq: Q3K
        8-16:
          isq: Q4K
    Ranges are [start, end); later entries override earlier overlaps.
    A range with no `isq` leaves those layers unquantized.
    """

    def __init__(self, per_layer: dict[int, GGMLType | HqqType | None]):
        self.per_layer = per_layer

    @classmethod
    def from_yaml_str(cls, text: str, num_layers: int | None = None) -> "Topology":
        import yaml

        doc = yaml.safe_load(text) or {}
        per_layer: dict[int, GGMLType | HqqType | None] = {}
        for rng, opts in doc.items():
            rng = str(rng)
            if "-" in rng:
                lo, hi = (int(x) for x in rng.split("-", 1))
            else:
                lo = int(rng)
                hi = lo + 1
            if hi < lo:
                raise ValueError(f"topology range {rng!r} is inverted")
            isq = parse_isq(str(opts["isq"])) if opts and opts.get("isq") else None
            for i in range(lo, hi):
                per_layer[i] = isq
        if num_layers is not None:
            for i in per_layer:
                if i >= num_layers:
                    raise ValueError(f"topology layer {i} >= num_layers {num_layers}")
        return cls(per_layer)

    @classmethod
    def from_yaml_file(cls, path: str, num_layers: int | None = None) -> "Topology":
        with open(path) as f:
            return cls.from_yaml_str(f.read(), num_layers)

    def isq_for_layer(self, layer_idx: int, default):
        return self.per_layer[layer_idx] if layer_idx in self.per_layer else default


def quantizable(shape: tuple[int, ...], gtype) -> bool:
    """A (out, in) weight is quantizable if `in` is a whole number of blocks
    (of HQQ groups)."""
    if isinstance(gtype, HqqType):
        return len(shape) == 2 and shape[1] % gtype.group_size == 0
    be, _ = GGML_BLOCK_INFO[GGMLType(int(gtype))]
    return len(shape) == 2 and shape[1] % be == 0
