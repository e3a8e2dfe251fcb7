"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library. The libraries go to
``_build/<hash>/`` inside the package (listed in ``.gitignore``), where the
hash covers the source and the command, so an edited source is rebuilt
and an unchanged one is loaded as it is (the hash also covers the shared
``csrc/*.cuh`` headers). :func:`build_all` starts one ``nvcc`` per source,
all at once. ``python3 -m repro_torch.kernels.build`` builds them and prints
ptxas's registers, shared memory and spills for every kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "paged_decode_attention", "gla_chunk", "latent_decode_attention",
           "slstm_scan", "slstm_scan_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list[str]:
    """The command that compiles ``csrc/<name>.cu`` into ``out``."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; known: {SOURCES}")
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    ``(path, process or None, tmp path)``."""
    path = _lib_path(name)
    if path.exists():
        return path, None, None
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp, nvcc_path()),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return path, proc, tmp


def _wait(started: dict) -> None:
    """Wait for every ``nvcc`` that ``_start`` began, then install the
    libraries; raise if any compile failed."""
    outs = {n: proc.communicate()[0] for n, (_, proc, _) in started.items() if proc}
    failed = [f"nvcc failed on {n}.cu (rc {started[n][1].returncode}):\n{out}"
              for n, out in outs.items() if started[n][1].returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    for path, proc, tmp in started.values():
        if proc:
            os.replace(tmp, path)   # atomic: a concurrent build sees all or nothing


def build_all() -> float:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source started together; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        _wait({n: _start(n) for n in SOURCES})
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            started = {name: _start(name)}
            _wait(started)
            _libs[name] = ctypes.CDLL(str(started[name][0]))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError()``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptxas_report() -> str:
    """ptxas's resource lines for every kernel of every source: each source
    compiled once more with ``-Xptxas -v`` into ``_build/ptxas/``, the
    sources in parallel."""
    out = BUILD_ROOT / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                  str(out / f"lib{n}.so"), str(CSRC / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in SOURCES}
    lines = []
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {n}.cu:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("spill" in line or "Used" in line):
                lines.append(f"{n}.cu {kernel[-60:]}: {line.strip()}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(f"built in {build_all():.1f}s")
    print(ptxas_report())
