"""Build and load the port's CUDA kernels.

Each ``csrc/<library>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, ``build/repro_torch/<library>-<digest>.so``
under the repository root, and is loaded with ``ctypes``; a library may
hold several entry points (`SIGNATURES`).  The digest covers the
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
# x, omega, delta, theta, y, mask, pphi, part, g; rows, n_real, L, d, q,
# c, q_true, live_raw, live_par, slab_rows, cluster, cols_per_cta,
# groups_raw, groups_par; stream
_FUSED_ARGS = (_P,) * 9 + (_I,) * 14 + (_P,)
_GQA_ARGS = (_P,) * 8 + (_I,) * 9 + (_P,)
# C signature of each entry point: symbol -> (library, argtypes)
SIGNATURES = {
    "rff_embed_f32": ("rff_embed", (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "parity_encode_batched_f32": ("parity_encode",
                                  (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "parity_encode_f32": ("parity_encode", (_P, _P, _P, _P, _I, _I, _I, _P)),
    # x, theta_t, y, mask, part, g, n, L, q, c, live_c, live_l, chain,
    # stream
    "linreg_grad_masked_f32": ("linreg_grad", (_P,) * 6 + (_I,) * 7 + (_P,)),
    # x, theta, y, p (partial residuals), part, g, m, q, c, splits, stream
    "linreg_grad_f32": ("linreg_grad", (_P,) * 6 + (_I,) * 4 + (_P,)),
    "rff_linreg_grad_masked_f32": ("rff_linreg_grad", _FUSED_ARGS),
    "rff_linreg_grad_masked_bf16": ("rff_linreg_grad", _FUSED_ARGS),
    # bf16, slab_rows, cluster, cols_per_cta -> clusters at once
    "rff_linreg_grad_max_clusters": ("rff_linreg_grad", (_I,) * 4),
    # q, k, v, k_pos, out, part_m, part_l, part_acc, B, T, H, K, hd, hd_v,
    # q_pos, window, split_tiles, stream
    "gqa_decode_f32": ("gqa_decode", _GQA_ARGS),
    "gqa_decode_bf16": ("gqa_decode", _GQA_ARGS),
}
LIBRARIES = tuple(dict.fromkeys(lib for lib, _ in SIGNATURES.values()))

_libs: dict = {}     # library -> loaded ctypes.CDLL
_loaded: dict = {}   # symbol -> ctypes function
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
    targets = {name: _target(name) for name in LIBRARIES}
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


def kernel(symbol: str):
    """The ctypes entry point `symbol`, building on first use."""
    fn = _loaded.get(symbol)
    if fn is None:
        lib, argtypes = SIGNATURES[symbol]
        if lib not in _libs:
            _libs[lib] = ctypes.CDLL(str(build_all()[lib]))
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return fn
