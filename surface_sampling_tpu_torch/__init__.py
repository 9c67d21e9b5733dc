"""surface_sampling_tpu_torch — VSSR-MC in PyTorch, with CUDA kernels for Hopper.

A port of ``surface_sampling_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The JAX package stays the reference; this package imports nothing of
it and nothing of JAX. It reads the reference's data files (slab
geometries, offset table, PaiNN and CHGNet weights) by path.

Layout follows the JAX package's module names so each function's
counterpart is easy to find. Inside, it is plain PyTorch: the chain axis
and the ensemble-member axis are written-out batch dimensions, and every
block the JAX package wrote as a Pallas TPU kernel that the ported paths
run is a hand-written CUDA kernel (``ops/painn_kernels.py``,
``ops/chgnet_kernels.py``, sources in ``csrc/``). Every entry point takes
``device=``; the default is ``"cuda"``, which raises when no card is
present.
"""

__version__ = "0.1.0"
