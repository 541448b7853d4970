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
    """JAX, the JAX package, and ml_dtypes (absent where the port runs:
    bf16 arrays travel through npz as uint16 bit views)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "archi_tpu", "ml_dtypes")


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

    from archi_tpu_torch.engine.ann_index import AnnFlatIndex
    from archi_tpu_torch.engine.ivf_index import IVFIndex
    from archi_tpu_torch.engine.ivfpq_index import IVFPQIndex
    from archi_tpu_torch.engine.kmeans import kmeans
    from archi_tpu_torch.engine.pq import PQCodec

    x = np.eye(4, 16, dtype=np.float32)
    for make in (default_device, lambda: FlatIndex(16), BM25Index,
                 lambda: TorchEmbedder(config=cfg),
                 lambda: TorchVectorStore(Emb()),
                 lambda: AnnFlatIndex(16, snapshot_kind="ivfpq"),
                 lambda: kmeans(x, 2), lambda: PQCodec(np.zeros((2, 4, 8))),
                 lambda: IVFIndex.build(x, None, nlist=2),
                 lambda: IVFPQIndex.build(x, nlist=2, m=2, ksub=4)):
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
    from archi_tpu_torch.ops.adc import adc_scores, adc_scores_lut16

    luts = torch.empty(4, 2, 16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scores(luts, torch.empty(4, 9, dtype=torch.uint8, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        adc_scores_lut16(luts, torch.empty(2, 9, dtype=torch.uint8, device=m))


def test_cpu_wrappers_count_no_launches():
    from archi_tpu_torch.ops import LAUNCHES, ROUTE_LAUNCHES
    from archi_tpu_torch.ops.attention import encoder_attention
    from archi_tpu_torch.ops.topk import fused_topk

    before, routes_before = dict(LAUNCHES), dict(ROUTE_LAUNCHES)
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    fused_topk(e[:2], e, torch.zeros(64), 64, k=3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    encoder_attention(q, q, q, torch.zeros(1, 4), sm_scale=0.5)
    from archi_tpu_torch.ops.adc import (adc_scores, adc_scores_lut16,
                                         pack_nibbles)

    luts = torch.from_numpy(rng.standard_normal((4, 2, 16)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 16, (4, 33)).astype(np.uint8))
    assert adc_scores(luts, codes).shape == (2, 33)
    assert adc_scores_lut16(luts, pack_nibbles(codes.t()).t()).shape == (2, 33)
    assert set(LAUNCHES) == {"fused_topk", "encoder_attention", "adc_scores",
                             "adc_scores_lut16"}
    assert LAUNCHES == before and ROUTE_LAUNCHES == routes_before


def test_build_finds_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from archi_tpu_torch.ops import _build

    assert _build.sources() == ["adc", "encoder_attention", "fused_topk"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert _build._stale("fused_topk")           # nothing built yet
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_topk"])
