"""ctypes loader of the native text-grid formatter (``heat2d_io.cpp``).

The library is built at first use with the host's C++ compiler (``g++``,
else ``c++``) into ``build/native/`` beside the package, never into the
package; its file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one reused. The build writes a
temporary file and renames it, so processes that build at once (the
ranks of a world) never load a torn library.

- ``compiler()`` is the compiler found on ``PATH``, or None;
- ``load()`` builds if needed and loads; with a compiler present, a build
  or load failure raises ``NativeBuildError``, never falls back;
- ``available()`` is False only when no compiler exists: then, and only
  then, the writers use the Python formatter (``io/writers.py`` names the
  one that ran).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "heat2d_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-Wall", "-fPIC", "-shared")
ENTRY_POINTS = ("heat2d_format_rowmajor", "heat2d_format_baseline")

_lock = threading.Lock()
_loaded: dict = {}


class NativeBuildError(RuntimeError):
    """The formatter failed to build or load although a compiler exists."""


def compiler():
    """The C++ compiler on ``PATH`` (``g++``, else ``c++``), or None."""
    return shutil.which("g++") or shutil.which("c++")


def available() -> bool:
    """True when the native formatter can be built here (a compiler is on
    ``PATH``); whether it then builds is ``load()``'s to say."""
    return compiler() is not None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libheat2d_io_{h.hexdigest()[:16]}.so"


def _build(cxx: str, path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{cxx} failed to build {SOURCE.name} "
                f"(rc {proc.returncode}): {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


class NativeIO:
    """The loaded library's two formatters."""

    def __init__(self, cdll: ctypes.CDLL, path: Path):
        self.path = path
        self._lib = cdll
        for name in ENTRY_POINTS:
            fn = getattr(cdll, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_char_p, ctypes.c_long]

    def _format(self, name: str, a: np.ndarray) -> str:
        a = np.ascontiguousarray(a, dtype=np.float32)
        nx, ny = a.shape
        cap = nx * ny * 24 + nx + 64
        buf = ctypes.create_string_buffer(cap)
        n = getattr(self._lib, name)(a.ctypes.data, nx, ny, buf, cap)
        if n < 0:
            raise RuntimeError(f"{name}: buffer too small (cap={cap})")
        return buf.raw[:n].decode("ascii")

    def format_rowmajor(self, a) -> str:
        return self._format("heat2d_format_rowmajor", a)

    def format_baseline(self, a) -> str:
        return self._format("heat2d_format_baseline", a)


def load() -> NativeIO:
    """The formatter, built on first use; raises ``NativeBuildError`` when
    no compiler exists or the build or load fails."""
    with _lock:
        cxx = compiler()
        if cxx is None:
            raise NativeBuildError("no C++ compiler (g++ or c++) on PATH")
        path = library_path()
        if path in _loaded:
            return _loaded[path]
        if not path.exists():
            _build(cxx, path)
        try:
            lib = NativeIO(ctypes.CDLL(str(path)), path)
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _loaded[path] = lib
        return lib
