"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``.  The
libraries land in ``_build/<hash>/`` beside this file (git-ignored), keyed
by a hash of every file in ``csrc/``, so an edited source rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source
at once and waits for all of them.  A failed build raises: nothing falls
back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
KERNELS = ("paged_decode", "paged_prefill", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (dtype, pointers..., ints..., floats..., stream)
SIGNATURES = {
    "paged_decode": [_I, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_F, _F, _P],
    "paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 8
    + [_F, _F, _P],
    "flash_attention": [_I, _P, _P, _P, _P] + [_I] * 10 + [_F, _F, _P],
}


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source on first use")
    return found


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel not yet built for the current sources, one
    ``nvcc`` process per source, all started together.  Returns the
    library path per kernel; raises with the compiler's output on failure.
    The ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    in ``<kernel>.log`` beside each library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {k: out / f"lib{k}.so" for k in KERNELS}
    procs = {}
    for k, lib in libs.items():
        if lib.exists():
            continue
        tmp = out / f"lib{k}.so.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{k}.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for k, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{k}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {k} (exit {proc.returncode}) ---\n{log}")
        else:
            tmp.replace(libs[k])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use), with its
    C entry point's argument and return types declared."""
    path = build_all()[name]
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    return lib
