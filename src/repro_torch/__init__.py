"""PyTorch/CUDA port of the DeltaBox checkpoint/rollback core.

The JAX package ``repro`` is the reference; this package imports none of it.
"""
