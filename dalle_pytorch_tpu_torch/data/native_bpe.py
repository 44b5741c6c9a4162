"""ctypes bindings for the native C++ byte-level BPE (`native/bpe.cpp`).

A copy of the JAX package's `data/native_bpe.py` (the port imports
nothing of that package). The shared library is compiled from the
repository's unedited `native/bpe.cpp` with `g++` (by name: the JAX
package takes `$CXX`) at first use, into `build/native/libdalle_bpe-
<hash>.so` at the repo root, named by a hash of the source, compiler and
flags so an edited source rebuilds; nothing builds at import. Tokenization is host-side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "bpe.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
# g++ by name, not $CXX: a compiler set there for other builds may link
# another C++ runtime than the one this process has loaded (on the card's
# machine $CXX names one whose library threw std::bad_alloc in bpe_load)
_COMPILER = "g++"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lib = None


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join((_COMPILER,) + _FLAGS).encode())
    return _BUILD_DIR / f"libdalle_bpe-{h.hexdigest()[:16]}.so"


def _build_library() -> Path:
    lib = _library_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_COMPILER, *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native BPE build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build_library()))
    lib.bpe_train.restype = ctypes.c_void_p
    lib.bpe_train.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.bpe_load.restype = ctypes.c_void_p
    lib.bpe_load.argtypes = [ctypes.c_char_p]
    lib.bpe_save.restype = ctypes.c_int
    lib.bpe_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    lib.bpe_vocab_size.restype = ctypes.c_int32
    lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
    lib.bpe_encode.restype = ctypes.c_int32
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.bpe_encode_batch.restype = ctypes.c_int32
    lib.bpe_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.bpe_decode.restype = ctypes.c_int32
    lib.bpe_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    _lib = lib
    return lib


class NativeBPE:
    """Handle to a trained native BPE model."""

    def __init__(self, handle: int):
        if not handle:
            raise ValueError("null native BPE handle")
        self._lib = _load_library()
        self._handle = handle

    @classmethod
    def train(cls, corpus: str, vocab_size: int = 8192) -> "NativeBPE":
        return cls(_load_library().bpe_train(corpus.encode("utf-8"), vocab_size))

    @classmethod
    def load(cls, model_path: Union[str, Path]) -> "NativeBPE":
        h = _load_library().bpe_load(str(model_path).encode("utf-8"))
        if not h:
            raise FileNotFoundError(f"cannot load native BPE model {model_path}")
        return cls(h)

    def save(self, model_path: Union[str, Path]) -> None:
        if self._lib.bpe_save(self._handle, str(model_path).encode("utf-8")) != 0:
            raise IOError(f"cannot save native BPE model to {model_path}")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and _lib is not None:
            _lib.bpe_free(handle)
            self._handle = None

    @property
    def vocab_size(self) -> int:
        return self._lib.bpe_vocab_size(self._handle)

    def encode(self, text: str, max_len: int = 1 << 16) -> List[int]:
        buf = (ctypes.c_int32 * max_len)()
        n = self._lib.bpe_encode(self._handle, text.encode("utf-8"), buf, max_len)
        return list(buf[: min(n, max_len)])

    def encode_batch(
        self,
        texts: Sequence[str],
        max_len: int,
        truncate: bool = True,
        n_threads: Optional[int] = None,
    ) -> np.ndarray:
        """Threaded batch encode -> zero-padded int32 [n, max_len]."""
        if n_threads is None:
            n_threads = min(len(texts), os.cpu_count() or 1, 8)
        encoded = [t.encode("utf-8") for t in texts]
        blob = b"\0".join(encoded) + b"\0"
        offsets = np.zeros(len(texts), dtype=np.int64)
        pos = 0
        for i, e in enumerate(encoded):
            offsets[i] = pos
            pos += len(e) + 1
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        rc = self._lib.bpe_encode_batch(
            self._handle,
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len,
            1 if truncate else 0,
            n_threads,
        )
        if rc != 0:
            raise RuntimeError(f"Input {texts[rc - 1]!r} is too long for context length {max_len}")
        return out

    def decode(self, ids: Sequence[int]) -> str:
        arr = np.asarray(list(ids), dtype=np.int32)
        max_bytes = max(len(arr) * 64, 256)
        buf = ctypes.create_string_buffer(max_bytes)
        n = self._lib.bpe_decode(
            self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr),
            buf, max_bytes,
        )
        return buf.raw[:n].decode("utf-8", errors="replace")
