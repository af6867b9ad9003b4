"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``),
count their launches, and say what card a plan is made for.

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

Every wrapper in ``ops`` reaches its kernel through ``call``: tensors go
as pointers, a launch gets the current stream of its tensors' card and
adds one to its wrapper's count (``launch_counts``) and to its entry's
(``entry_launches``), and a nonzero return raises (``check``).

``device_caps`` is the one answer to "what card does this plan for": a
card's own limits, or the H100's for a tensor on the CPU, so that the
CPU runs plan the launches the card would.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

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
        "heat_td_rows_split": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _P]),
        "heat_td_rows_rhs_split": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _P]),
        "heat_td_rows_split_info": (_I, [_I, _I, _I, _P]),
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


# --------------------------------------------------------------------- #
# Calling an entry point, and the launch counts
# --------------------------------------------------------------------- #

#: Every kernel wrapper's launch name, by library: the keys of
#: ``launch_counts``.
LAUNCH_NAMES = {
    "stencil": ("step", "tile_multi", "tile_multi_resid", "resident"),
    "ensemble": ("ens_resident", "ens_tile_multi", "ens_tile_multi_conv"),
    "family": ("fam_resident", "fam_tile_multi"),
    "shard": ("shard_tile_multi", "shard_tile_multi_resid", "shard_fused"),
    "tridiag": ("td_coeffs", "td_rows", "td_lanes"),
}

#: Launches per wrapper name since the last ``reset_launch_counts``.
_launches = {k: 0 for names in LAUNCH_NAMES.values() for k in names}
#: Launches per C entry point in this process, never reset.
_entry_launches = {e: 0 for sigs in SIGNATURES.values() for e in sigs}
#: (library, entry) -> (the loaded entry point, the positions of its
#: pointer parameters but the last), looked up once.
_entries: dict = {}
_Tensor = torch.Tensor


def _entry(library: str, entry: str) -> tuple:
    argtypes = SIGNATURES[library][entry][1]
    ptrs = tuple(i for i, t in enumerate(argtypes[:-1]) if t is _P)
    found = _entries[library, entry] = (getattr(load(library), entry), ptrs)
    return found


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream



def call(library: str, entry: str, name, what: str, *args,
         device=None) -> None:
    """Call C entry point ``entry`` of ``csrc/<library>.cu`` on ``args``,
    a tensor in a pointer parameter passed as its data pointer (None is a
    null pointer); raise with ``what`` when it returns an error. With a
    launch ``name`` (a key of ``LAUNCH_NAMES``) the call is a launch: the
    current stream of ``device`` (by default the first tensor's) is
    appended as its last parameter, and the launch counts under ``name``
    and ``entry``. Without one (a query such as ``heat_device_caps``,
    whose last parameter is its output buffer) nothing is appended or
    counted.

    Only the pointer parameters are looked at, and a tensor is told by its
    exact type (an isinstance check against ``torch.Tensor`` goes through
    its metaclass for every argument): a launch's host cost stays that of
    a call with its pointers written out."""
    fn, ptrs = _entries.get((library, entry)) or _entry(library, entry)
    cargs = list(args)
    for i in ptrs:
        a = cargs[i]
        if type(a) is _Tensor:
            if device is None:
                device = a.device
            cargs[i] = a.data_ptr()
    if name is not None:
        cargs.append(_stream(device))
        _launches[name] += 1
        _entry_launches[entry] += 1
    rc = fn(*cargs)
    if rc != 0:
        check(load(library), rc, what)


def launch_counts(library: str | None = None) -> dict:
    """Launches per wrapper name since the last ``reset_launch_counts``:
    of every library, or of ``library``'s wrappers only. The plain
    versions, on the CPU, count nothing."""
    if library is None:
        return dict(_launches)
    return {k: _launches[k] for k in LAUNCH_NAMES[library]}


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def entry_launches(*entries: str) -> int:
    """Launches of the C entry points ``entries`` in this process (never
    reset, so a caller counts the difference across its work)."""
    return sum(_entry_launches[e] for e in entries)


# --------------------------------------------------------------------- #
# The card a plan is made for
# --------------------------------------------------------------------- #

class DeviceCaps(NamedTuple):
    l2_bytes: int
    smem_optin: int
    sm_count: int
    cooperative: bool


#: The H100's opt-in shared memory per block (232,448 bytes).
H100_SMEM_OPTIN = 232448
#: The H100's SMs.
H100_SM_COUNT = 132
#: The H100's L2 cache (50 MiB).
H100_L2_BYTES = 50 * 2 ** 20
#: Shared memory of one SM (228 KB), of which each resident block also
#: takes 1 KB for the system: what bounds blocks per SM besides threads.
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
#: Registers, threads and blocks an SM of the H100 holds at most.
SM_REGISTERS = 65536
SM_THREADS = 2048
SM_BLOCKS = 32
#: Static shared memory of the tile kernel (H3's warp sums: 4 bytes for
#: each of its 8 warps), left out of the dynamic shared memory a plan
#: may use (``smem_limit``).
STATIC_SMEM = 32

_H100 = DeviceCaps(H100_L2_BYTES, H100_SMEM_OPTIN, H100_SM_COUNT, True)
_caps: dict[int, DeviceCaps] = {}


def device_caps(device) -> DeviceCaps:
    """The limits a plan for ``device`` is made against: a card's own,
    read once per card through the stencil library (which builds at first
    use); for any other device the H100's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return _H100
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _caps:
        buf = (ctypes.c_int * 4)()
        with torch.cuda.device(idx):
            call("stencil", "heat_device_caps", None, "heat_device_caps", buf)
        _caps[idx] = DeviceCaps(buf[0], buf[1], buf[2], bool(buf[3]))
    return _caps[idx]


def smem_limit(device) -> int:
    """Dynamic shared memory a block may use on ``device``."""
    return device_caps(device).smem_optin - STATIC_SMEM


def round_up(n: int, m: int) -> int:
    """``n`` rounded up to a whole number of ``m``: a plan's pitch."""
    return -(-n // m) * m
