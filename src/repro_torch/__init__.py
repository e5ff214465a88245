"""PyTorch/CUDA port of the ColBERT-serve retrieval stack.

The SPLADE → residual gather → decompress+MaxSim rerank → (hybrid
α-fusion) → top-k path runs on an NVIDIA Hopper card through
hand-written CUDA kernels (``kernels/csrc``): SPLADE stage 1,
decompress+MaxSim and the fused rerank top-k; MaxSim over fp32
embeddings is the fourth, on no serving path. Every entry point takes a
``device`` (default ``"cuda"``); tests pass ``device="cpu"``, which runs
the kernels' plain PyTorch versions instead.
"""
