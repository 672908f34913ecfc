"""vgaligner_tpu_torch: the variation-graph aligner on PyTorch and CUDA.

A second implementation of ``vgaligner_tpu`` (the JAX/TPU package, kept
beside it as the reference) for one NVIDIA Hopper GPU:

  * host code without jax (graph model, index build, I/O, the native
    C++ runtime, the POA oracle) is imported from the JAX package's
    directory through ``_shared`` without running its ``__init__``;
  * array code is PyTorch on an explicit ``torch.device``;
  * the chaining DP, the POA DP and the POA traceback are CUDA C++
    kernels for sm_90a (``kernels/csrc``), each with a plain PyTorch
    twin in the module that wraps it.  A CPU tensor runs the twin; a
    CUDA tensor launches the kernel or raises.

This package never imports jax or ``vgaligner_tpu``.
"""

__version__ = "0.1.0"
