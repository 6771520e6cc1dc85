"""PyTorch port of the unified paged serving path, with hand-written CUDA
kernels for Hopper (``kernels/csrc``).

The JAX package ``repro`` is the reference; this package imports none of
it (nor ``jax``) and keeps its own copies of what it needs.  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""

