"""archi_tpu_torch — the retrieval engine of ``archi_tpu`` on PyTorch and CUDA.

A port of the JAX package's hybrid-retrieval main path (WordPiece → BERT
encoder → flat index + BM25 → fused top-k) to PyTorch, with the two Pallas
kernels of that path rewritten as CUDA C++ for Hopper (``csrc/``).  Module
names mirror ``archi_tpu`` so each file's counterpart is easy to find; the
store is ``archi_tpu_torch.engine.vectorstore.TorchVectorStore``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.  This package
imports neither ``jax`` nor ``archi_tpu``.
"""
