"""Device policy and the build of the hand-written CUDA kernels.

The JAX package resolves ``interpret`` here: Mosaic lowers only on a TPU,
everywhere else its kernels run in Pallas interpret mode. The port's
counterpart of "can run the kernel" is a CUDA device: on one, every kernel
wrapper launches its CUDA kernel; on the CPU it runs the kernel's plain
PyTorch version (``kernels/ref.py``). Nothing here falls back from one to
the other on its own.

Kernels live in ``src/repro_torch/csrc/*.cu``. Each is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` at the repository root, at first use, and loaded with
``ctypes``. The library's file name carries a hash of its source, so an
edited source builds anew and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}  # loaded libraries, one per source


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=``; raises when CUDA is
    asked for and missing instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def attn_bf16(lowp: Optional[bool] = None) -> bool:
    """bf16 dot-input toggle for the attention kernels (``REPRO_ATTN_BF16``).

    Dot-product *inputs* drop to bf16 while the online-softmax statistics and
    the output accumulator stay f32. Resolved at each call, so flipping the
    environment variable between calls takes effect.
    """
    if lowp is not None:
        return bool(lowp)
    return os.environ.get("REPRO_ATTN_BF16", "0") == "1"


def can_run_kernel(device) -> bool:
    return torch.device(device).type == "cuda"


def auto_attn_impl(seq_len: int, *, device="cuda") -> str:
    """Attention policy for ``--attn-impl auto``: ``naive`` for short
    sequences (the score matrix is small), the flash kernel for long ones on
    a CUDA device, and the plain online-softmax ``chunked`` path elsewhere."""
    if seq_len <= 512:
        return "naive"
    return "pallas" if can_run_kernel(device) else "chunked"


def auto_decode_impl(cache_len: int, *, device="cuda") -> str:
    """Decode-attention policy for ``--attn-impl auto``: ``naive`` for short
    caches, the flash-decode kernel for long caches on a CUDA device."""
    if cache_len < 512:
        return "naive"
    return "pallas" if can_run_kernel(device) else "naive"


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_libraries(names: Iterable[str]) -> None:
    """Compile every named ``csrc/<name>.cu`` that has no library yet, one
    ``nvcc`` per source, all started together. The compiler's
    ``-Xptxas -v`` report (registers, spills) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        rc = proc.wait()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_libraries([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error: its return value is
    ``cudaGetLastError()`` right after the launch, or
    ``cudaErrorInvalidValue`` for an argument it refused."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: error {rc} "
                           f"({lib.kernel_error_string(rc).decode()})")
