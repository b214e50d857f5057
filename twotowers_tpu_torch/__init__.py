"""twotowers_tpu_torch — the two-tower retrieval framework on PyTorch + CUDA.

A port of ``twotowers_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package imports neither JAX nor
anything of it. So far it holds the serving path: char tokenizer -> lookup
embedding -> ``mean`` / ``avg_pool`` tower -> dense index -> fused
score + top-k, whose CUDA kernel lives in ``csrc/score_topk.cu`` and is
built with ``nvcc`` at first use (``kernels/build.py``), never at import.

Entry points (``TwoTowerSearch``, ``VectorCollection``, ``RetrievalService``,
``ModelRuntime``) run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
