"""The host runtime of the transcripts: Poseidon and Keccak-256 in C++.

csrc/hostmath.cpp is compiled at first use by g++ (`CXX`) into
`build/torch_kernels/libhostmath_<hash>.so`, named by the hash of the
source and the flags as the CUDA kernels are (ops/kernels.py), and loaded with ctypes.  A failed build or load raises
`RuntimeError` with the compiler's output: there is no fallback to the
Python versions, which stay as the plain versions the library is tested
against (transcript/poseidon.py `permute_plain`, utils/refcrypto.py
`keccak256`).

`poseidon_permute(state)` and `keccak256(data)` take and give Python ints
and bytes, as the JAX package's native runtime does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from .ops.kernels import BUILD_DIR, CSRC
from .utils import refcrypto as rc

SOURCE = CSRC / "hostmath.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhostmath_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is there; raise RuntimeError with the
    compiler's output if that fails."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host library build failed: {cmd}: {e}") from e
    if p.returncode != 0:
        raise RuntimeError(f"host library build failed: {cmd}: exit "
                           f"{p.returncode}\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _scalars(xs) -> bytes:
    return b"".join((int(x) % rc.FR).to_bytes(32, "little") for x in xs)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        h = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"host library load failed: {path}: {e}") from e
    h.hm_init.argtypes = [ctypes.c_char_p]
    h.hm_init.restype = None
    h.hm_poseidon_setup.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_char_p]
    h.hm_poseidon_setup.restype = ctypes.c_int
    h.hm_poseidon_permute.argtypes = [ctypes.c_char_p]
    h.hm_poseidon_permute.restype = None
    h.hm_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_char_p]
    h.hm_keccak256.restype = None
    from .transcript.poseidon import R_F, R_P, T, poseidon_constants
    h.hm_init(rc.FR.to_bytes(32, "little"))
    rcs, mds = poseidon_constants(rc.FR)
    if h.hm_poseidon_setup(T, R_F, R_P, _scalars(v for r in rcs for v in r),
                           _scalars(v for r in mds for v in r)) != 0:
        raise RuntimeError(f"hm_poseidon_setup refused T={T}")
    _lib = h
    return h


def poseidon_permute(state: list) -> list:
    """The Poseidon permutation of the transcript (T=3, R_F=8, R_P=57) over
    BN254 Fr; `state` is reduced mod r."""
    from .transcript.poseidon import T
    if len(state) != T:
        raise ValueError(f"Poseidon state must hold {T} elements")
    h = _load()
    buf = ctypes.create_string_buffer(_scalars(state), 32 * T)
    h.hm_poseidon_permute(buf)
    raw = buf.raw
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(T)]


def keccak256(data: bytes) -> bytes:
    h = _load()
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    h.hm_keccak256(data, len(data), out)
    return out.raw
