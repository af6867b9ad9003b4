"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, which ``ctypes`` loads; no PyTorch header is
compiled, so a build takes seconds instead of the minutes an extension
built with ``torch.utils.cpp_extension`` takes. A library's file name
carries a hash of its source, the shared headers and the flags, so an
edited source or flag set is rebuilt and an unchanged one is reused.

The build runs at first use, never at import: the CPU tests import every
module of the package on a machine without ``nvcc``.

``EVENTS`` logs every ``nvcc`` build started and every library loaded in
this process, as ``("build" | "load", name)`` in order: what "compile"
means for the port, read by ``analysis.recompile.CompileWatch``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signature of every entry point: name -> (restype, argtypes).
#: Pointers and the stream are c_void_p, never the 32-bit default.
SIGNATURES = {
    "stencil": {
        "heat_error_string": (ctypes.c_char_p, [_I]),
        "heat_device_caps": (_I, [_P]),
        "heat_step": (_I, [_P, _P, _I, _I, _F, _F, _F, _I, _P]),
        "heat_tile_multi": (_I, [_P, _P, _P, _P, _I, _I, _F, _F, _F, _I,
                                 _I, _I, _I, _I, _P]),
        "heat_tile_info": (_I, [_I, _P]),
        "heat_func_attrs": (_I, [_I, _P]),
        "heat_resident": (_I, [_P, _P, _P, _P, _F, _F, _F, _I, _I, _P]),
    },
    "ensemble": {
        "heat_error_string": (ctypes.c_char_p, [_I]),
        "heat_ens_resident": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _P]),
        "heat_ens_tile": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _P]),
        "heat_ens_func_attrs": (_I, [_I, _P]),
    },
    "family": {
        "heat_error_string": (ctypes.c_char_p, [_I]),
        "heat_fam_resident": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _P]),
        "heat_fam_tile": (_I, [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P]),
        "heat_fam_tile_info": (_I, [_I, _I, _P]),
    },
    "tridiag": {
        "heat_error_string": (ctypes.c_char_p, [_I]),
        "heat_td_coeffs": (_I, [_P, _P, _I, _I, _P]),
        "heat_td_rows": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "heat_td_lanes": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "heat_td_rows_rhs": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P]),
        "heat_td_lanes_rhs": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P]),
    },
    "shard": {
        "heat_error_string": (ctypes.c_char_p, [_I]),
        "heat_shard_tile": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I,
                                 _P]),
        "heat_shard_fused": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _F, _F, _I, _I, _I, _I, _I, _P]),
        "heat_shard_enable_peer": (_I, [_I]),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}

#: ("build" | "load", library name) for every nvcc build started and every
#: library loaded in this process, in order
EVENTS: list[tuple[str, str]] = []


def nvcc_path() -> str:
    """The CUDA compiler, from PATH or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of heat2d_tpu_torch are built on the machine with "
        "the card; on the CPU the wrappers run their plain versions")


def library_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` builds to, keyed by content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    EVENTS.append(("build", name))
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> list[Path]:
    """Build every library that is missing, one ``nvcc`` per source, all
    started together; returns the library paths."""
    names = list(SIGNATURES) if names is None else list(names)
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use, with
    every entry point's argtypes and restype declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, = build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
            EVENTS.append(("load", name))
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.heat_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
