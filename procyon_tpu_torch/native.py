"""ctypes bindings for the native data-path library (counterpart of
procyon_tpu/native.py): batch protein tokenization with chunk splitting,
MLM masking and a FASTA offset index.

The library is this package's own copy of the C++ source,
`csrc/procyon_native.cpp`. It is compiled with `g++ -O3 -shared -fPIC` the
first time an entry point runs, into `build/procyon_tpu_torch/` at the
repository root (beside the CUDA kernels, ops/_build.py), under a name keyed
by the source's digest, and loaded with ctypes. Nothing is built at import,
and nothing is read from or written to the JAX package's `native/`. Every
entry point keeps the reference's pure-python fallback, used when no
compiler or library is at hand: host data code, not a device path.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from procyon_tpu_torch.data import protein_tokenizer as pt

_SRC = Path(__file__).resolve().parent / "csrc" / "procyon_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" \
    / "procyon_tpu_torch"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """The library of csrc/procyon_native.cpp, keyed by its source and the
    compiler flags."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"procyon_native-{digest[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.count_rows.restype = ctypes.c_int
        lib.batch_encode.restype = ctypes.c_int
        lib.fasta_index.restype = ctypes.c_long
        lib.fasta_get.restype = ctypes.c_long
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def batch_encode(seqs, *, max_len=1024, long_strategy="split",
                 pad_rows_to=0):
    """Native batch_encode; falls back to protein_tokenizer.batch_encode."""
    lib = get_lib()
    if lib is None:
        return pt.batch_encode(seqs, max_len=max_len,
                               long_strategy=long_strategy,
                               pad_rows_to=pad_rows_to)
    split = 1 if long_strategy == "split" else 0
    arr = (ctypes.c_char_p * len(seqs))(*[s.encode() for s in seqs])
    n_rows = lib.count_rows(arr, len(seqs), max_len, split)
    R = max(n_rows, 1)
    if pad_rows_to:
        R = max(R, pad_rows_to)
    longest = max((min(len(s), max_len) for s in seqs), default=1)
    width = longest + 2
    tokens = np.full((R, width), pt.PAD_IDX, np.int32)
    group_ids = np.zeros((R,), np.int32)
    row_valid = np.zeros((R,), np.float32)
    lib.batch_encode(
        arr, len(seqs), max_len, split,
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), R, width,
        group_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        row_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return pt.ProteinBatch(tokens=tokens, group_ids=group_ids,
                           row_valid=row_valid, num_groups=len(seqs))


def mask_for_mlm(tokens: np.ndarray, seed: int, *, mask_prob=0.15):
    """Native MLM masking (xorshift128+ seeded by `seed`); the fallback
    draws from numpy's generator: another stream, the same distribution."""
    lib = get_lib()
    if lib is None:
        return pt.mask_for_mlm(tokens, np.random.default_rng(seed),
                               mask_prob=mask_prob)
    flat = np.ascontiguousarray(tokens, np.int32)
    out_t = np.empty_like(flat)
    out_l = np.empty_like(flat)
    lib.mask_for_mlm(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(flat.size), ctypes.c_float(mask_prob),
        ctypes.c_uint64(seed),
        out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out_t.reshape(tokens.shape), out_l.reshape(tokens.shape)


class FastaIndex:
    """Indexed FASTA reader: record offsets from one scan of the file
    (native, or the python fallback), then a record's sequence read from
    its offset."""

    def __init__(self, path: str):
        self.path = path
        lib = get_lib()
        if lib is not None:
            n = lib.fasta_index(path.encode(), None, 0)
            if n < 0:
                raise FileNotFoundError(path)
            self.offsets = np.zeros((n,), np.int64)
            lib.fasta_index(
                path.encode(),
                self.offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n)
            self._native = True
        else:
            offsets = []
            pos = 0
            with open(path, "rb") as f:
                for line in f:
                    if line.startswith(b">"):
                        offsets.append(pos)
                    pos += len(line)
            self.offsets = np.asarray(offsets, np.int64)
            self._native = False
        self._size = os.path.getsize(path)

    def __len__(self):
        return len(self.offsets)

    def get(self, idx: int, max_len: int = 1 << 20) -> str:
        lib = get_lib()
        if lib is not None and self._native:
            # a record's sequence is shorter than its bytes in the file, so
            # a buffer of those bytes (+ the terminator) reads it whole when
            # max_len would: the same string, without a 1 MiB buffer a read
            start = int(self.offsets[idx])
            end = int(self.offsets[idx + 1]) if idx + 1 < len(self.offsets) \
                else self._size
            cap = min(max_len, end - start + 1)
            buf = ctypes.create_string_buffer(cap)
            n = lib.fasta_get(self.path.encode(), ctypes.c_int64(start), buf,
                              cap)
            return buf.value[:max(n, 0)].decode()
        with open(self.path, "rb") as f:
            f.seek(int(self.offsets[idx]))
            f.readline()  # header
            parts = []
            for line in f:
                if line.startswith(b">"):
                    break
                parts.append(line.strip().decode())
            return "".join(parts)
