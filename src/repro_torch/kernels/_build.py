"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` at first use and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``); ``csrc/*.cuh`` are headers the
sources share.  Libraries go into ``kernels/build/<hash>/``, keyed by a
hash of all the sources, the headers and the flags, so an edited source
rebuilds and an unchanged one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source, all at once.  A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
# per source: the build's wall seconds and nvcc's -Xptxas -v report
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(nvcc: str, src: Path, out: Path):
    """Start one nvcc compiling ``src`` into a temporary file next to
    ``out``; the caller renames it into place when nvcc succeeds."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build (or find built) the libraries of the named sources, all
    sources by default, compiling the missing ones in parallel."""
    srcs = {s.stem: s for s in _sources()}
    names = list(srcs) if names is None else names
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = {n: out_dir / f"lib{n}.so" for n in names}
    missing = [n for n in names if not outs[n].exists()]
    if missing:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = {n: _start(nvcc, srcs[n], outs[n]) for n in missing}
        failed = []
        for n, (proc, tmp, cmd) in jobs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, outs[n])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _LIBS[name] = lib
    return lib
