"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` into a shared library with a
plain C interface (loaded with ctypes), all sources at once, into
`build/torch_kernels/` beside the package.  A library is named by the hash
of its sources, so an edited kernel rebuilds and an unchanged one is reused.
Nothing is built when this module is imported: the first launch on a CUDA
tensor builds (or `build_all()` does it up front).

`launches` counts, per kernel, the launches its wrapper made; wrappers add
one where they call into the library and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HEADERS = ("bn254.cuh",)
SOURCES = {
    "cios_rate": "cios_rate.cu",
    "field_binop": "field_binop.cu",
    "field_scan": "field_scan.cu",
    "ntt": "ntt.cu",
    "ntt_mxu": "ntt_mxu.cu",
    "point_chain": "point_chain.cu",
    "point_ops": "point_ops.cu",
    "point_scan": "point_scan.cu",
    "quotient_forest": "quotient_forest.cu",
    "scan_madd": "scan_madd.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches: Counter = Counter()
_libs: dict = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "h2t_cios_rate": [_P, _P, _I, _I, _I, _I, _P],
    "h2t_field_binop": [_I, _I, _P, _P, _P, _L, _L, _P],
    "h2t_field_scan": [_I, _I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _P],
    "h2t_field_reduce": [_I, _I, _P, _P, _P, _P, _L, _L, _L, _I, _P],
    "h2t_ntt_pass": [_P, _L, _P, _L, _I, _I, _I, _I, _P, _P, _L, _P, _L, _P],
    "h2t_dft_s8": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _P],
    "h2t_point_add": [_P, _P, _P, _L, _P],
    "h2t_point_double": [_P, _P, _L, _P],
    "h2t_point_add_mixed": [_P, _P, _P, _L, _P],
    "h2t_point_scan": [_P, _L, _P, _P, _L, _L, _L, _I, _P],
    "h2t_point_reduce": [_P, _L, _P, _L, _L, _L, _I, _P],
    "h2t_point_scan_affine": [_P, _L, _P, _P, _L, _L, _L, _I, _P],
    "h2t_point_reduce_affine": [_P, _L, _P, _L, _L, _L, _I, _P],
    "h2t_point_windows": [_P, _P, _L, _I, _I, _P],
    "h2t_point_horner": [_P, _P, _L, _I, _I, _P],
    "h2t_point_fixed_mul": [_P, _P, _P, _L, _P],
    "h2t_scan_madd": [_P, _P, _P, _L, _I, _P],
    "h2t_quotient_forest": [_P, _L, _P, _P, _I, _I, _I, _P, _P],
}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every missing library, one nvcc per source, all in parallel.
    Returns the wall seconds spent; raises if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            print(f"[build] {name}:\n{log.strip()}", flush=True)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    h = _libs.get(name)
    if h is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        h = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(h, fn):
                getattr(h, fn).argtypes = argtypes
                getattr(h, fn).restype = ctypes.c_int
        _libs[name] = h
    return h


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def require_cuda_int32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
