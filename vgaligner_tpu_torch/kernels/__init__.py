"""Build, bind and count the port's CUDA kernels.

The kernels (``csrc/*.cu``: chaining DP fast and exact, POA DP, POA
traceback, the fused POA DP + traceback for rows up to 256 columns,
local POA) are compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  The build runs
at first use, into ``vgaligner_tpu_torch/_build/``, keyed by a hash of
the sources and the flags, so a fresh checkout builds everything it
needs and a rebuilt source never loads a stale library.  A failed build
raises with nvcc's stderr; a good one keeps ptxas's register and
shared-memory report of every kernel in ``build_log``.

Every C entry point enqueues on the stream it is given (the wrapper
passes ``torch.cuda.current_stream()``), allocates nothing, and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.

``LAUNCHES`` counts launches per kernel: each wrapper adds one right
where it launches, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("chain_dp.cu", "chain_dp_exact.cu", "poa_dp.cu", "poa_traceback.cu",
           "poa_dp_tb.cu", "poa_local.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"chain_dp": 0, "chain_dp_exact": 0, "poa_dp": 0, "poa_traceback": 0,
            "poa_dp_tb": 0, "poa_local": 0, "chain_gap_cost": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")
    return found


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"vg_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source/flag hash has no library yet."""
    global build_seconds, build_log
    import fcntl

    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "kernels.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = nvcc_path()
        objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                for s, o in zip(SOURCES, objs)]
        t0 = time.monotonic()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
        failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            outs.append(proc.stdout)
            if proc.returncode != 0:
                failed.append((link, proc.returncode))
        build_seconds = time.monotonic() - t0
        build_log = "".join(outs)
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        if failed:
            cmd, rc = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        so.vg_chain_dp.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        so.vg_chain_dp.restype = ci
        so.vg_chain_gap_cost.argtypes = [vp, ci, ci, vp, vp]
        so.vg_chain_gap_cost.restype = ci
        so.vg_chain_dp_exact.argtypes = [vp] * 5 + [ci] * 5 + [vp] * 4
        so.vg_chain_dp_exact.restype = ci
        so.vg_poa_local.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 7
        so.vg_poa_local.restype = ci
        so.vg_poa_dp.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 5
        so.vg_poa_dp.restype = ci
        so.vg_poa_traceback.argtypes = [vp] * 4 + [ci] * 4 + [vp] * 3
        so.vg_poa_traceback.restype = ci
        so.vg_poa_dp_tb.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 8
        so.vg_poa_dp_tb.restype = ci
        so.vg_poa_dp_tb_occupancy.argtypes = [ci, ci, ci, vp]
        so.vg_poa_dp_tb_occupancy.restype = ci
        so.vg_cuda_error_string.argtypes = [ci]
        so.vg_cuda_error_string.restype = ctypes.c_char_p
        _lib = so
        return _lib


def check_row_width(name: str, W: int) -> None:
    """The row widths a one-block-per-problem row kernel (POA DP, local
    POA) takes: one thread per column up to W = 1,024, then 1,024
    threads of W / 1,024 columns each, up to W = 16,384."""
    if not ((W % 32 == 0 and W <= 1024) or (W % 1024 == 0 and W // 1024 in (2, 4, 8, 16))):
        raise ValueError(f"{name}: unsupported row width W={W} "
                         "(a multiple of 32 up to 1,024, or 1,024 x 2/4/8/16)")


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().vg_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
