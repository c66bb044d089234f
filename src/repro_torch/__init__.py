"""PyTorch/CUDA port of the LocalAdaSEG system (the JAX package ``repro``
is the reference it is held against).

Layout mirrors ``repro``: ``core`` (Algorithm 1 on a worker-stacked state),
``problems`` (the bilinear game), ``kernels`` (plain PyTorch twins plus
hand-written CUDA kernels for Hopper, built from ``csrc/`` at first use),
``ps`` (the serial Parameter-Server engine), ``obs`` (spans) and
``random`` (a threefry2x32 clone of ``jax.random``).

Entry points that create tensors take ``device=`` and default to
``"cuda"``; without a GPU that default raises instead of running on the CPU.
"""
