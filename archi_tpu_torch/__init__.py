"""archi_tpu_torch — the retrieval engine of ``archi_tpu`` on PyTorch and CUDA.

A port of the JAX package's hybrid-retrieval main path (WordPiece → BERT
encoder → flat index + BM25 → fused top-k) to PyTorch, with the two Pallas
kernels of that path rewritten as CUDA C++ for Hopper (``csrc/``).  Module
names mirror ``archi_tpu`` so each file's counterpart is easy to find.  The
store is ``archi_tpu_torch.engine.vectorstore.TorchVectorStore``; the
data-manager service that owns it is
``archi_tpu_torch.bin.service_data_manager``, and the chat service that
answers a user's questions over it is ``archi_tpu_torch.bin.service_chat``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.  This package
imports neither ``jax`` nor ``archi_tpu``.
"""

__version__ = "0.1.0"
