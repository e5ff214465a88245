"""PyTorch/CUDA port of the ColBERT-serve retrieval stack.

The SPLADE → residual gather → decompress+MaxSim rerank → (hybrid
α-fusion) → top-k path runs on an NVIDIA Hopper card through two
hand-written CUDA kernels (``kernels/csrc``). Every entry point takes a
``device`` (default ``"cuda"``); tests pass ``device="cpu"``, which runs
the kernels' plain PyTorch versions instead.
"""
