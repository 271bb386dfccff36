"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, ``build/repro_torch/<name>-<digest>.so`` under the
repository root, and is loaded with ``ctypes``.  The digest covers the
sources and the flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing is built at import: the first call of a kernel on a
CUDA tensor builds all of them (``build_all``), one ``nvcc`` per source,
started together.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each library's entry point: (symbol, argtypes)
SIGNATURES = {
    "rff_embed": ("rff_embed_f32", (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "parity_encode": ("parity_encode_batched_f32",
                      (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "linreg_grad": ("linreg_grad_masked_f32",
                    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
}

_loaded: dict = {}   # name -> ctypes function of a loaded library
#: per-library compiler output (``-Xptxas -v``: registers, shared memory,
#: spills) of the builds this process ran
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, all at once.

    Returns {name: path of the shared library}.  Raises RuntimeError with
    the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def kernel(name: str):
    """The ctypes entry point of library `name`, building on first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = build_all()[name]
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
