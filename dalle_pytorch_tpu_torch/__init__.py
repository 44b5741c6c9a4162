"""PyTorch/CUDA port of dalle_pytorch_tpu for NVIDIA Hopper (H100).

The JAX package `dalle_pytorch_tpu` stays the reference; this package is
held against it by the `tests/test_torch_*.py` parity tests and never
imports it (or jax/flax). Module names mirror the JAX package so each
piece's counterpart is easy to find.

Ported so far: KV-cached text->image generation through the micro
`serving.engine.GenerationEngine` — the DALLE cached decode path, the
dVAE pixel decoder, sampling, the byte tokenizer, the checkpoint reader
and weight loader, and one hand-written CUDA kernel for the cached
attention (`ops/flash_decode.py`, `csrc/flash_decode.cu`).

Importing the package builds nothing and needs no card: kernels are
compiled with `nvcc` at first use on a CUDA tensor (`kernels.py`).
"""

__version__ = "0.1.0"
