"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Every ``videollamb_torch/csrc/*.cu`` file is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and the
objects are linked into one shared library with a plain C interface. The
build runs at first use, goes into ``build/kernels/`` at the root of the
checkout and is keyed by a hash of the sources, their shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged tree loads the cached library. No binary is
committed. Without ``nvcc`` a CUDA run raises: the kernels have no
fallback on the card. The first :func:`kernels` call is the ``kernels.load``
span (``utils/profiling.py``), with a ``kernels.compile`` span inside it
when the library had to be built.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. The wrappers of
forward-only kernels call :func:`refuse_grad` before they launch. Every
wrapper is :func:`counted`: its ``launches`` attribute counts the launches
that ran, and :data:`COUNTED` lists the wrappers, so a caller that captures
launches in a CUDA graph can count each replay's (``serve/paged.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points: (restype, argtypes). A launch entry
# returns its cudaError_t as an int.
SIGNATURES = {
    "spatial_attention_bf16": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "spatial_core_bf16": (_I, (_P,) * 4 + (_I,) * 3 + (_P,)),
    "temporal_attention_bf16": (_I, (_P, _P, _I, _I, _I, _I, _I, _P)),
    "temporal_core_bntd_bf16": (_I, (_P,) * 4 + (_I,) * 5 + (_P,)),
    "temporal_core_fm_bf16": (_I, (_P,) * 4 + (_I,) * 5 + (_P,)),
    "block_attention_bf16": (_I, (_P,) * 4 + (_I,) * 5 + (ctypes.c_float, _I, _P)),
    "flash_attention_bf16": (_I, (_P,) * 5 + (_I,) * 5 + (ctypes.c_float, _I, _I)
                             + (ctypes.c_longlong,) * 6 + (_P,)),
    "gathered_paged_attention_int8": (_I, (_P,) * 12 + (_I,) * 6 + (_P,)),
    "paged_fresh_write_int8": (_I, (_P,) * 6 + (_I,) * 5 + (_P,)),
    "paged_attention_stats": (_I, (_P, _I) + (_P,) * 9 + (_I,) * 7 + (_P,)),
    "int4_matmul": (_I, (_P,) * 5 + (_I,) * 5 + (_P,)),
    "int4_matmul_ksplit": (_I, (_I,) * 5),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of videollamb_torch are built from "
        "source at first use and need the CUDA toolkit")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """The library for the current sources: the hash covers every ``.cu`` and
    every header they share (``*.cuh``), so an edited header rebuilds too."""
    digest = hashlib.sha256()
    for src in sorted(_sources() + list(CSRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvideollamb_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    from videollamb_torch.utils.profiling import span

    with span("kernels.compile"):
        _compile(out)
    return out


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():  # one nvcc per source, all running at once
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    log, failed = [], []
    for cmd, _, proc in jobs:
        log += [" ".join(cmd), proc.communicate()[0]]
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode})")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += [" ".join(link), proc.stdout + proc.stderr]
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode})")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    log_path = out.with_suffix(".log")
    log_path.write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}; see {log_path}:\n"
                           f"{chr(10).join(log)[-4000:]}")
    os.replace(tmp, out)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            from videollamb_torch.utils.profiling import span

            with span("kernels.load"):
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def refuse_grad(name: str, *tensors, route: str = "it has no VJP in the JAX package "
                "either; call it under torch.no_grad()") -> None:
    """A forward-only kernel's output has no ``grad_fn``: raise where autograd
    would want one, instead of cutting the graph silently."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is a forward-only CUDA kernel and its output has no "
                           f"gradient; {route}")


# The counted kernel wrappers, in the order their modules were imported.
COUNTED: list = []


def counted(fn):
    """Give a kernel wrapper a ``launches`` counter, which the wrapper adds to
    after each launch, and enter it in :data:`COUNTED`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """Each counted wrapper's launches so far."""
    return {fn: fn.launches for fn in COUNTED}


def launches_since(before: dict) -> dict:
    """The launches of each wrapper that launched since ``before`` (a
    :func:`launch_counts`)."""
    return {fn: n - before.get(fn, 0) for fn, n in launch_counts().items()
            if n != before.get(fn, 0)}


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
