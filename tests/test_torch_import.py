"""The PyTorch port imports neither jax nor the JAX package, nor, at import
time, the packages the card's machine lacks (safetensors, ml_dtypes, yaml).

One subprocess imports mistralrs_tpu_torch and then each of its submodules in
turn, recording after each import whether `jax`, `mistralrs_tpu`,
`safetensors`, `ml_dtypes` or `yaml` has entered sys.modules; every module is
one case.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mistralrs_tpu_torch"


def _module_names() -> list[str]:
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


MODULES = _module_names()

_PROBE = """
import importlib, json, sys
out = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "mistralrs_tpu", "safetensors",
                                              "ml_dtypes", "yaml"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_module_is_listed():
    assert "mistralrs_tpu_torch" in MODULES
    assert "mistralrs_tpu_torch.ops.quant_matmul" in MODULES
    assert {"mistralrs_tpu_torch.quant.gptq", "mistralrs_tpu_torch.quant.hqq",
            "mistralrs_tpu_torch.ops.splash",
            "mistralrs_tpu_torch.ops.ragged_attention",
            "mistralrs_tpu_torch.ops.grouped_gemm", "mistralrs_tpu_torch.gguf.reader",
            "mistralrs_tpu_torch.gguf.writer", "mistralrs_tpu_torch.pipeline.gguf",
            "mistralrs_tpu_torch.quant.isq", "mistralrs_tpu_torch.models.loader",
            "mistralrs_tpu_torch.pipeline.speculative"} <= set(MODULES)
    assert len(MODULES) >= 30


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(imported, module):
    assert imported[module] == [], f"{module} pulled in {imported[module]}"
