"""The port's native tier: its own copies of the JAX package's C and C++
sources (``src/``), built with the host compiler at first use
(:mod:`ray_tpu_torch.native._build`) — the shared-memory object store, the C
id types and frame codec, and the parallel file I/O pool."""
