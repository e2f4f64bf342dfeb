"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``.  This takes seconds, where a build
against PyTorch's headers takes minutes.

The build happens at first use, into ``src/repro_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and the flags, so
a fresh checkout builds itself and an unchanged one reuses its library.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("hi_gate.cu", "decode_attention.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_vp = ctypes.c_void_p
_i = ctypes.c_int
# argtypes per C entry point: c_void_p for every pointer and the stream, so
# that no pointer is cut to 32 bits.
SIGNATURES = {
    "hi_gate_launch": (_vp, _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp),
    "decode_attention_launch": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                                _i, ctypes.c_float, _vp),
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    ptxas: Tuple[str, ...]  # register / shared-memory / spill lines


_loaded: Optional[Tuple[ctypes.CDLL, BuildInfo]] = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch are built from csrc/ at first use")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def compile_commands(nvcc: str, out_dir: Path) -> Tuple[list, list]:
    """(one compile command per source, the link command)."""
    objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                for s, o in zip(SOURCES, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
            *map(str, objs)]
    return compiles, link


def _ptxas_lines(text: str) -> Tuple[str, ...]:
    keep = re.compile(r"ptxas info\s*: (Compiling entry|Function properties|"
                      r"Used \d+ registers)|bytes stack frame")
    return tuple(ln.strip() for ln in text.splitlines() if keep.search(ln))


def _run_build(out_dir: Path) -> Tuple[str, ...]:
    nvcc = find_nvcc()
    compiles, link = compile_commands(nvcc, out_dir)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in compiles]
    logs, failed = [], []
    for cmd, p in zip(compiles, procs):
        log, _ = p.communicate()
        logs.append(log)
        if p.returncode:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
    return _ptxas_lines("\n".join(logs))


def build() -> BuildInfo:
    """Build the library unless a build of the same sources exists."""
    final = BUILD_ROOT / source_hash()
    lib = final / LIB_NAME
    if lib.exists():
        ptx = (final / "ptxas.txt").read_text().splitlines()
        return BuildInfo(lib, 0.0, tuple(ptx))
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        ptx = _run_build(tmp)
        (tmp / "ptxas.txt").write_text("\n".join(ptx))
        try:
            os.rename(tmp, final)   # atomic; a concurrent build may win
        except OSError:
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.perf_counter() - t0, ptx)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _loaded
    if _loaded is None:
        info = build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = (lib, info)
    return _loaded[0]


def build_info() -> BuildInfo:
    library()
    return _loaded[1]


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
