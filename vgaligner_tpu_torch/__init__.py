"""vgaligner_tpu_torch: the variation-graph aligner on PyTorch and CUDA.

A second implementation of ``vgaligner_tpu`` (the JAX/TPU package, kept
beside it as the reference) for one NVIDIA Hopper GPU:

  * the host runtime is the port's own copy of the reference's jax-free
    modules, at the same relative paths (``graph/``, ``io/``,
    ``index/build.py`` and ``kmer_gen.py``, ``utils/``, ``ops/poa.py``,
    ``models/host_pipeline.py``, and the native C++ runtime
    ``native/``, which g++ builds into ``_build/`` at first use);
  * array code is PyTorch on an explicit ``torch.device``;
  * the chaining DP, the POA DP and traceback and the local POA are CUDA
    C++ kernels for sm_90a (``kernels/csrc``), each with a plain PyTorch
    twin in the module that wraps it.  A CPU tensor runs the twin; a
    CUDA tensor launches the kernel or raises.

This package never imports jax or ``vgaligner_tpu``, and reads no file
of the JAX package.
"""

from .graph import graph_from_gfa  # noqa: F401
from .index import Index  # noqa: F401

__version__ = "0.1.0"
