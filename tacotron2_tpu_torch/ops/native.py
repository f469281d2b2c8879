"""Build and load the port's native host library: the FLAC decoder and the
prosody feature extractor (``native/flac_decoder.cpp``, ``native/prosody.cpp``).

The two sources are compiled with ``g++ -O3 -fPIC -std=c++17 -shared`` into
``build/native/libttsnative-<hash>.so`` at the root of the checkout (listed
in ``.gitignore``) at first use, and loaded with ``ctypes``. The hash covers
the sources and the flags, so an edited source is rebuilt. The build takes a
file lock: test workers and ``preprocess``'s process pool may all reach it
at once. Nothing is written into ``native/``, which the JAX package builds
with its own Makefile. A failed build raises. Imports neither torch nor
CUDA, so ``preprocess``'s workers stay on the host.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "flac_decoder.cpp", ROOT / "native" / "prosody.cpp")
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libttsnative-{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; -> its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {out.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed, its entry points declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.flac_decode_file.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(i32p), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.flac_decode_file.restype = ctypes.c_int
            lib.flac_free.argtypes = [i32p]
            lib.flac_free.restype = None
            lib.prosody_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
            lib.prosody_extract.restype = ctypes.c_int
            _LIB = lib
        return _LIB
