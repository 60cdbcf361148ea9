"""PyTorch/CUDA port of `openai_whisper_compression_tpu` for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel the JAX package runs on
the ported path is a hand-written CUDA kernel under `csrc/`, built at first
use (`ops.kernels`). This package never imports jax.
"""
