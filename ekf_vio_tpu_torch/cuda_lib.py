"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface: pointers and the
stream as ``void*``, sizes and the device index as ``int``, and an ``int``
return that is the ``cudaGetLastError()`` after its launches.  ``load(name)`` compiles the
source for ``sm_90a`` at first use into ``_build/`` (keyed by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited source
rebuilds) and caches the loaded library for the life of the process.
Nothing is built at import time.

Every kernel counts its own launches on the card (``csrc/launch_count.cuh``),
so the replays of a captured CUDA graph count as eager launches do.  A
wrapper notes the device of each launch (``note_device``);
``launch_count(name)`` reads a library's counters on those devices and
``reset_launch_count(name)`` sets them to 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: no reader sees a partial library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.launch_count.argtypes = [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_ulonglong)]
    lib.reset_launch_count.argtypes = [ctypes.c_int]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# the devices each library's kernels were launched on, by library name
_devices: dict[str, set[int]] = {}


def note_device(name: str, device: int) -> None:
    """Record that library ``name`` launched a kernel on ``device``: its
    counter there is read by ``launch_count``.  Bookkeeping only; the
    kernel counts the launch itself."""
    _devices.setdefault(name, set()).add(device)


def launch_count(name: str) -> int:
    """Launches of library ``name``'s kernels since the last
    ``reset_launch_count``, summed over the devices they ran on, each
    read after a synchronisation of that device; 0 if none ran."""
    import torch

    total = 0
    for device in sorted(_devices.get(name, ())):
        torch.cuda.synchronize(device)
        out = ctypes.c_ulonglong()
        lib = load(name)
        check(lib, lib.launch_count(device, ctypes.byref(out)),
              f"{name} launch_count")
        total += out.value
    return total


def reset_launch_count(name: str) -> None:
    """Set library ``name``'s launch counters to 0, after the launches in
    flight have finished."""
    import torch

    for device in sorted(_devices.get(name, ())):
        torch.cuda.synchronize(device)
        lib = load(name)
        check(lib, lib.reset_launch_count(device),
              f"{name} reset_launch_count")


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on the device of tensor ``t``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
