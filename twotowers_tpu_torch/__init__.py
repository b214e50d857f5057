"""twotowers_tpu_torch — the two-tower retrieval framework on PyTorch + CUDA.

A port of ``twotowers_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package imports neither JAX nor
anything of it. It holds the serving path (char tokenizer -> lookup
embedding -> ``mean`` / ``avg_pool`` tower -> dense index -> fused
score + top-k, ``csrc/score_topk.cu``), the config-driven training path
(``utils.load_config``; char / word / BPE / WordPiece tokenizers; the
``lookup`` and ``positional`` embeddings, whose word-scale lookup is
``csrc/gather_rows.cu`` forward and ``csrc/scatter_add_rows.cu`` backward;
the pooled and the ``cnn`` / ``rnn`` / ``transformer`` towers; the
pretrained embeddings; five losses; checkpoints; the ``profile:`` trace),
evaluation, the search CLI and the mean-word-vector baseline
(``index/{cli,glove}.py``), the parallel layer (``parallel/``,
``index/sharded.py``), serving with its optional Chroma backend and search
page (``serve/``), the Hub export and load (``hub/``, ``huggingface_hub``
imported inside each call), the run reports (``reports/``), the
experiment runner and the MS MARCO scripts (``scripts/``) and the data
factory (``data/factory``, which needs pandas and is not imported by any
other module). The CUDA kernels are built with ``nvcc`` at first use
(``kernels/build.py``), never at import. Checkpoints the JAX package wrote
(orbax) are converted by the repo's ``bridge/orbax_to_torch.py``, which
this package never imports.

Entry points (``train_model``, ``load_trained_model``, ``TwoTowerSearch``,
``MeanVectorSearch``, ``GloVeSearch``, ``VectorCollection``,
``RetrievalService``, ``ModelRuntime``, ``serve.app.build_service``, the
evaluation and search CLIs, ``scripts.train``, ``scripts.generate_and_train``,
``scripts.train_with_msmarco``) run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
