"""Package rules of the PyTorch/CUDA port.

- No file of ``archi_tpu_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  the JAX package ``archi_tpu``: checked on the source (AST) and on what an
  import of every module really loads (a fresh interpreter).
- Entry points default to CUDA and raise without it; they never fall back
  to the CPU quietly, and the kernel wrappers take their plain versions
  only for CPU tensors.
- The kernel build finds its sources and refuses to run without nvcc.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "archi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "archi_tpu")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import archi_tpu_torch\n"
        "for m in pkgutil.walk_packages(archi_tpu_torch.__path__,"
        " 'archi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "archi_tpu_torch.engine.vectorstore" in mods
    assert not [m for m in mods if _forbidden(m)]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    from archi_tpu_torch.engine.bm25 import BM25Index
    from archi_tpu_torch.engine.flat_index import FlatIndex
    from archi_tpu_torch.engine.vectorstore import TorchVectorStore
    from archi_tpu_torch.models.bert import BertConfig
    from archi_tpu_torch.models.embedder import TorchEmbedder
    from archi_tpu_torch.utils.hardware import default_device, on_cuda

    assert not on_cuda()
    cfg = BertConfig(vocab_size=128, hidden_size=16, num_layers=1,
                     num_heads=2, intermediate_size=32,
                     max_position_embeddings=64)

    class Emb:
        dim = 16

    for make in (default_device, lambda: FlatIndex(16), BM25Index,
                 lambda: TorchEmbedder(config=cfg),
                 lambda: TorchVectorStore(Emb())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert default_device("cpu") == torch.device("cpu")
    assert TorchVectorStore(Emb(), device="cpu").index.emb.device.type == "cpu"
    assert TorchEmbedder(config=cfg, device="cpu").compute_dtype == torch.float32


def test_wrappers_raise_on_devices_they_do_not_serve():
    """Plain versions only for CPU tensors: anything else launches the
    kernel or raises (here: tensors on the meta device)."""
    from archi_tpu_torch.ops.attention import encoder_attention
    from archi_tpu_torch.ops.topk import fused_topk

    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_topk(torch.empty(2, 8, device=m), torch.empty(64, 8, device=m),
                   torch.empty(64, device=m), 64, k=3)
    q = torch.empty(1, 4, 2, 8, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_attention(q, q, q, torch.empty(1, 4, device=m), sm_scale=1.0)


def test_cpu_wrappers_count_no_launches():
    from archi_tpu_torch.ops import LAUNCHES
    from archi_tpu_torch.ops.attention import encoder_attention
    from archi_tpu_torch.ops.topk import fused_topk

    before = dict(LAUNCHES)
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    fused_topk(e[:2], e, torch.zeros(64), 64, k=3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    encoder_attention(q, q, q, torch.zeros(1, 4), sm_scale=0.5)
    assert LAUNCHES == before


def test_build_finds_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from archi_tpu_torch.ops import _build

    assert _build.sources() == ["encoder_attention", "fused_topk"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert _build._stale("fused_topk")           # nothing built yet
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_topk"])
