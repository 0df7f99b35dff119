"""Build the CUDA kernels under procyon_tpu_torch/csrc at first use.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, under `build/procyon_tpu_torch/` at the repository root,
keyed by a hash of its source and the headers it may include
(`csrc/*.cuh`), and loads with ctypes. The build runs only
when a wrapper first launches a kernel on a CUDA tensor, never at import.

Every C entry point takes device pointers and the stream as `void*`, ints
as `int`, floats as `float`, and returns `cudaGetLastError()` after its
launch; `check` turns a non-zero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "procyon_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, keyed by its source, the shared
    headers (csrc/*.cuh) and the target flags."""
    src = (_CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same source exists.
    ptxas's register/shared-memory report goes to `<library>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
           "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; `signatures` maps each C
    function to its ctypes argtypes (restype is int, the CUDA error)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def refuse_grad(what: str, *tensors) -> None:
    """A kernel without a backward would hand back an output cut from the
    autograd graph. Its wrapper calls this before it dispatches: with grad
    mode on and an input off the CPU that requires grad, it raises instead
    (on the CPU the plain versions are differentiated by torch)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            and t.device.type != "cpu" for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and an input requires "
            "grad; run it under torch.no_grad() or detach the inputs")
