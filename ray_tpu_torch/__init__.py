"""PyTorch/CUDA port of ray_tpu's LLM serving path and train step.

The JAX package ``ray_tpu`` is the reference this package is held against;
nothing here imports it (or JAX). Layout mirrors it module for module:
``ops`` (attention kernels, forward and backward, hand-written CUDA under
``ops/csrc``), ``models`` (decoder, its train step, cached generation and
model checkpoints), ``serve`` (the continuous-batching engine, its block
allocator and prefix cache), ``runtime`` (admission control), ``train``
(framed checkpoints), plus ``convert`` (JAX param trees and train states as
numpy arrays to tensors). Entry points run on the GPU unless the caller
asks for the CPU.
"""
