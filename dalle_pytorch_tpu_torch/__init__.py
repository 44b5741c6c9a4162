"""PyTorch/CUDA port of dalle_pytorch_tpu for NVIDIA Hopper (H100).

The JAX package `dalle_pytorch_tpu` stays the reference; this package is
held against it by the `tests/test_torch_*.py` parity tests and never
imports it (or jax/flax). Module names mirror the JAX package so each
piece's counterpart is easy to find.

Ported so far: text->image generation from a checkpoint, end to end
through the `generate` CLI (tokenizers, the micro `GenerationEngine`,
the cached and uncached samplers, CLIP rerank, PNG output); training
(the DALLE, dVAE and CLIP trainers), on one GPU or, for the DALLE, over
several processes (dp, fsdp and ring attention over sp; `launch`); the
continuous and paged serving engines, tensor-parallel among them, behind
the HTTP server and the replica fleet (router, supervisor, vitals, fleet
telemetry); and a hand-written CUDA kernel for every TPU kernel of the JAX
package
(`csrc/`: flash decode, flash attention, and the head dims above 256).
ROADMAP.md lists what is left.

Importing the package builds nothing and needs no card: kernels are
compiled with `nvcc` at first use on a CUDA tensor (`kernels.py`).
"""

__version__ = "0.1.0"
