"""twotowers_tpu_torch — the two-tower retrieval framework on PyTorch + CUDA.

A port of ``twotowers_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package imports neither JAX nor
anything of it. It holds the serving path (char tokenizer -> lookup
embedding -> ``mean`` / ``avg_pool`` tower -> dense index -> fused
score + top-k, ``csrc/score_topk.cu``), the config-driven training path
(``utils.load_config``; char / word / BPE / WordPiece tokenizers; the
``lookup`` and ``positional`` embeddings, whose word-scale lookup is
``csrc/gather_rows.cu`` forward and ``csrc/scatter_add_rows.cu`` backward;
the pooled and the ``cnn`` / ``rnn`` / ``transformer`` towers; five
losses; checkpoints) and evaluation. The CUDA kernels are built with
``nvcc`` at first use (``kernels/build.py``), never at import.

Entry points (``train_model``, ``load_trained_model``, ``TwoTowerSearch``,
``VectorCollection``, ``RetrievalService``, ``ModelRuntime``, the
evaluation CLI) run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
