"""Session set-up shared by every test directory of the repo.

The JAX package compiles its native host library on first use, next to
its source.  Under pytest-xdist every worker that finds no library would
compile it at once, into one temporary file, and a worker that loses
that race runs its native tests as skipped.  Building the library here,
in the controlling process before any worker starts, leaves every worker
a current library to load.  Where the JAX package cannot be imported
(a machine without jax), nothing is built.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        from vgaligner_tpu import native
    except ImportError:
        return
    native.get_lib()
