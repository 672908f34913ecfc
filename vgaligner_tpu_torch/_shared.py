"""Jax-free access to the JAX package's host modules.

The host side of the aligner (graph model, index build/load, FASTA/GAF
I/O, the POA oracle, the native C++ runtime) never calls jax, but the
JAX package's own ``__init__`` imports jax unconditionally, and so do
its ``ops/__init__`` and ``models/__init__``.  The port therefore never
imports ``vgaligner_tpu``.  Instead this module becomes a package whose
search path is the JAX package's directory, so

    from vgaligner_tpu_torch._shared.index.build import Index

loads ``vgaligner_tpu/index/build.py`` as a module of this package
without running ``vgaligner_tpu/__init__.py``.  ``ops`` and ``models``
are registered as empty package objects before anything imports them,
so their jax-importing ``__init__`` files never run either; their
jax-free modules (``ops/poa.py``, ``models/host_pipeline.py``) import
through them.  The native runtime's lazy ``from ..ops.poa import`` then
resolves inside this package too.

In a process that also imports the JAX package (the parity tests) the
two module trees are distinct objects: two ``QuerySequence`` classes,
two ``native`` loaders.  Both build the same ``_host_kernels.so`` next
to its source with the JAX package's build step, so the port's copy of
that step runs under the JAX copy's loader lock and, against other
processes of the port, under a lock file.
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
import types

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF_DIR = os.path.join(_REPO, "vgaligner_tpu")
BUILD_DIR = os.path.join(_REPO, "vgaligner_tpu_torch", "_build")

__path__ = [_REF_DIR]

for _sub in ("ops", "models"):
    _name = f"{__name__}.{_sub}"
    if _name not in sys.modules:
        _pkg = types.ModuleType(_name)
        _pkg.__path__ = [os.path.join(_REF_DIR, _sub)]
        _pkg.__package__ = _name
        sys.modules[_name] = _pkg
    setattr(sys.modules[__name__], _sub, sys.modules[_name])

native = importlib.import_module(f"{__name__}.native")

_build_lock = threading.Lock()
_native_build = native._build


def _serialised_native_build():
    """The native loader's own build step, serialised with the JAX
    copy's loader lock (same process) and a lock file (other processes
    of the port)."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    twin = sys.modules.get("vgaligner_tpu.native")
    twin_lock = twin._lock if twin is not None and twin is not native else threading.Lock()
    with _build_lock, twin_lock, open(os.path.join(BUILD_DIR, "native.lock"), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        return _native_build()


native._build = _serialised_native_build


def require_native():
    """The native runtime's library; the port has no Python fallbacks."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError(
            "the native host runtime (vgaligner_tpu/native/host_kernels.cpp) "
            "did not build; the port needs g++ and does not fall back"
        )
    return lib
