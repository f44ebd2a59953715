"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``.
Libraries are built at first use into ``_build/`` inside the package (listed
in ``.gitignore``), named by a hash of their source so an edited kernel is
rebuilt; ``build_kernels`` starts one ``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0. The wrapper
that launches a kernel counts it in ``utils/trace.py``'s counters
(``b1.launches`` for ``rasterize_tiles``, ``b2.launches`` for ``mesh_expand``,
``face_rows.launches`` for ``face_data_rows``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

KERNELS = ("rasterize_tiles", "mesh_expand", "face_data_rows")

# --fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions round them, so kernel and plain version agree bit for bit:
# the rasterizer's face ids then equal the plain version's on near-tied
# depths too. The price: a multiply-add is two instructions, so the FP32
# rate these kernels can reach is half the card's FMA peak
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_entry_points: dict[tuple[str, str], tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels that are not built yet, all in parallel.

    Returns each compiled kernel's ``ptxas`` report (registers, shared
    memory, spills); raises with the compiler's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
        reports[name] = log
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def entry_point(name: str, argtypes: list, symbol: str | None = None):
    """The C function ``symbol`` (by default ``name``, the kernel's launcher)
    of the library built from ``csrc/<name>.cu``, building it first if
    needed; its argument types are set once."""
    symbol = symbol or name
    cached = _entry_points.get((name, symbol))
    if cached is None:
        path = library_path(name)
        if not path.exists():
            build_kernels([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        cached = _entry_points[(name, symbol)] = (lib, fn)  # the library stays loaded
    return cached[1]


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
