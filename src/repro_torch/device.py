"""Device resolution, numpy <-> torch word helpers, and the CUDA kernel build.

Words. The JAX package stores keys, values, sequence numbers and TTL
expiries as ``uint32``. PyTorch has no ordering or arithmetic on
``torch.uint32`` on the CPU, so the port keeps every 4-byte word as an
``int32`` *bit-view* of the same bits: the device holds exactly as many
bytes as the reference (``DeviceViewManager.resident_bytes`` matches
it), the CUDA kernels read the words as ``uint32_t``, and plain torch
code orders them unsigned through :func:`ordered`, which flips the sign
bit (``u - 2**31`` as a signed int32 orders like ``u`` unsigned). Words
go back to ``uint32`` numpy at the host boundary (:func:`u32_np`).

Kernels. ``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
build runs on first use (:func:`kernel_library`), one ``nvcc`` per
source started together, into ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags so that
an edited source never loads a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

SIGN = -(2**31)  # xor with this orders int32 bit-views as uint32


def resolve(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Defaults to the card. Asking for CUDA where there is none raises:
    the port never carries on quietly on the CPU; callers that want the
    CPU (the tests) say ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_words(a, device) -> torch.Tensor:
    """uint32 (or int32) numpy array -> int32 bit-view tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype != np.int32:
        a = a.astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def u32_np(t: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 numpy array (host)."""
    return t.detach().cpu().numpy().view(np.uint32)


def ordered(t: torch.Tensor) -> torch.Tensor:
    """int32 bit-view whose signed order is the words' unsigned order."""
    return t ^ SIGN


def ordered_scalar(u: int) -> int:
    """:func:`ordered` for a host uint32 value, as a Python int."""
    return int(u) + SIGN


# ---- CUDA kernel library -------------------------------------------------

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
BUILD_LOG = ""  # nvcc/ptxas output of the build this process ran


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels cannot build")


def _build(sources: list[Path], out: Path) -> str:
    """Compile every source at once, then link one shared library."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        for cmd, _, p in procs:
            text, _ = p.communicate()
            log.append(text)
            if p.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{text}")
        lib_tmp = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib_tmp), *(str(o) for _, o, _ in procs)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{p.stdout}{p.stderr}")
        os.replace(lib_tmp, out)
    return "".join(log)


_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (anchors, queries, out, g, q, kw, stride, sms, minus_one, stream)
    "remix_anchor_search": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    # (selectors, cursors, rows, runid, absidx, newest, pad, n, d, r, sel_u8, sms, stream)
    "remix_selector_decode": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
}


def kernel_library():
    """The loaded kernel library, building it on first use."""
    global _LIB, BUILD_LOG
    if _LIB is None:
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.iterdir()):
            h.update(src.name.encode() + src.read_bytes())
        so = BUILD_DIR / f"libremix_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_LOG = _build(sources, so)
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s card (kernels size grids by it)."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as a raw pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
