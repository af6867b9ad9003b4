"""Binary state dumps and checkpoint/resume, byte-compatible with
``heat2d_tpu/io/binary.py``.

A dump is the grid as raw native-endian float32 in global row-major
order (the reference's MPI-IO layout). A checkpoint is a dump plus a JSON
sidecar (``<path>.meta.json``: step, shape, dtype, the binary's sha256,
the config, and the format tag ``heat2d-tpu-checkpoint-v1``), so a
checkpoint written by either stack loads in the other. An auxiliary
field (a diffusivity grid, an observation mask, a recovered inverse
solution: ``save_field``) is a raw dump of its own dtype plus a sidecar
of the format ``heat2d-tpu-field-v1``, byte for byte the JAX package's.
Every write is staged to a ``.tmp`` file, fsync'd and promoted with
``os.replace``.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

CHECKPOINT_FORMAT = "heat2d-tpu-checkpoint-v1"

#: dtypes a field file may carry. A bool field (an observation mask) is
#: stored as uint8 bytes with dtype "bool" in the sidecar, and loads back
#: as bool.
FIELD_DTYPES = ("float32", "float64", "int32", "uint8", "bool")

FIELD_FORMAT = "heat2d-tpu-field-v1"


class CheckpointCorruptError(ValueError):
    """A checkpoint failed its integrity checks (digest mismatch,
    truncated binary, unreadable sidecar)."""


def _host_f32(u) -> np.ndarray:
    """A host float32 array from a numpy array or a tensor on any device."""
    if hasattr(u, "detach"):
        u = u.detach().cpu().numpy()
    return np.asarray(u, dtype=np.float32)


def _host(a) -> np.ndarray:
    """A host array of a numpy array or a tensor on any device, its dtype
    kept."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _sha256_file(path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_path(path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_bytes_atomic(data: bytes, path) -> None:
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_binary(u, path) -> None:
    """Raw f32 row-major dump, byte-identical to the MPI-IO file layout."""
    _write_bytes_atomic(_host_f32(u).tobytes(), path)


def grid_blocks(grid) -> list:
    """This process's blocks of a ``ShardedGrid`` at their global
    offsets, ``[(row0, col0, block), ...]`` (blocks of other processes
    left out, padding included)."""
    bm, bn = grid.block_shape
    return [(i * bm, j * bn, blk) for i, row in enumerate(grid.blocks)
            for j, blk in enumerate(row) if blk is not None]


def _stage_file(tmp, nx: int, ny: int) -> None:
    """Size the staging file of an (nx, ny) float32 grid (process 0's
    part of a collective write; a barrier must follow across
    processes)."""
    with open(tmp, "wb") as f:
        f.truncate(nx * ny * 4)


def _write_local_blocks(blocks, tmp, nx: int, ny: int) -> None:
    """Write ``[(row0, col0, block), ...]`` (tensors or host arrays) into
    the sized staging file ``tmp`` at their offsets, cropped to (nx, ny),
    then fsync it. No collective: safe on any thread. Each block goes out
    by positioned writes of its rows (one write where it spans whole
    rows), straight from its buffer: a write releases the GIL, so a
    worker thread writing a block holds up no other thread."""
    fd = os.open(str(tmp), os.O_WRONLY)
    try:
        for r0, c0, blk in blocks:
            if r0 >= nx or c0 >= ny:
                continue   # wholly padding
            r1 = min(r0 + blk.shape[0], nx)
            c1 = min(c0 + blk.shape[1], ny)
            a = np.ascontiguousarray(_host_f32(blk[:r1 - r0, :c1 - c0]))
            if c0 == 0 and c1 == ny:
                _pwrite_all(fd, a, r0 * ny * 4)
                continue
            for i in range(r1 - r0):
                _pwrite_all(fd, a[i], ((r0 + i) * ny + c0) * 4)
        os.fsync(fd)
    finally:
        os.close(fd)


def _pwrite_all(fd, a: np.ndarray, offset: int) -> None:
    """``os.pwrite`` of a contiguous array's bytes at ``offset``, retried
    past short writes."""
    view = memoryview(a).cast("B")
    while view:
        n = os.pwrite(fd, view, offset)
        view, offset = view[n:], offset + n


def _write_blocks(grid, tmp, nx: int, ny: int) -> None:
    """Write this process's blocks of ``grid`` into the staged global
    file ``tmp`` at their offsets, cropped to (nx, ny). Across processes
    a collective: process 0 sizes the file, a barrier, every process
    writes its blocks, a barrier (a shared filesystem is assumed, as
    MPI-IO assumes one)."""
    from heat2d_tpu_torch.parallel.multihost import barrier, process_index
    multi = grid.spans_processes
    if not multi or process_index() == 0:
        _stage_file(tmp, nx, ny)
    if multi:
        barrier()
    _write_local_blocks(grid_blocks(grid), tmp, nx, ny)
    if multi:
        barrier()


def write_binary_sharded(grid, path, shape=None) -> None:
    """Per-shard write of a ``ShardedGrid`` (the MPI_File_write_all
    analogue, grad1612_mpi_heat.c:182-189): each shard writes its block
    into the one global row-major f32 file at its offset, cropped to the
    true domain ``shape`` (default: the grid's (nx, ny)), so the bytes are
    those of ``write_binary`` of the gathered, cropped grid. No full grid
    is assembled; the file is staged and promoted like every write.

    On a grid that spans processes the call is COLLECTIVE: each process
    writes its own blocks into the one file, process 0 promotes it after
    the closing barrier, and no process returns before it has."""
    from heat2d_tpu_torch.parallel.multihost import barrier, process_index
    nx, ny = shape if shape is not None else (grid.nx, grid.ny)
    tmp = str(path) + ".tmp"
    _write_blocks(grid, tmp, nx, ny)
    if not grid.spans_processes:
        os.replace(tmp, str(path))
        return
    if process_index() == 0:
        os.replace(tmp, str(path))
    barrier()


def read_binary(path, shape) -> np.ndarray:
    a = np.fromfile(path, dtype=np.float32)
    expected = int(np.prod(shape))
    if a.size != expected:
        raise ValueError(
            f"{path}: expected {expected} float32 values for shape {shape}, "
            f"found {a.size}")
    return a.reshape(shape)


def write_text_atomic(text: str, path) -> None:
    """Commit a text artifact crash-consistently: staged to
    ``path + '.tmp'``, fsync'd, promoted with ``os.replace``."""
    _write_bytes_atomic(text.encode(), path)


def write_json_atomic(obj, path, **dump_kwargs) -> None:
    """``write_text_atomic`` for one JSON document."""
    dump_kwargs.setdefault("indent", 2)
    write_text_atomic(json.dumps(obj, **dump_kwargs) + "\n", path)


def checkpoint_tmp_path(path) -> str:
    """The staging file a checkpoint is written to before its commit."""
    return str(path) + ".tmp"


def commit_checkpoint_files(tmp_path, path, step: int, config,
                            out_shape) -> None:
    """Promote a fully written staging binary to a checkpoint: digest,
    fsync, ``os.replace`` the binary, then the sidecar with the digest
    the same way, then fsync the directory. A crash between the two
    replaces leaves a pair whose digest does not match, which
    ``load_checkpoint`` rejects. Both windows are announced to
    ``resil.chaos`` (``mid_write`` before the digest, ``pre_meta`` before
    the sidecar), where the JAX package announces them."""
    from heat2d_tpu_torch.resil import chaos
    chaos.checkpoint_point("mid_write")
    digest = _sha256_file(tmp_path)
    _fsync_path(tmp_path)
    os.replace(tmp_path, path)
    chaos.checkpoint_point("pre_meta")
    meta = {
        "step": int(step),
        "shape": [int(s) for s in out_shape],
        "dtype": "float32",
        "sha256": digest,
        "config": config.to_dict() if hasattr(config, "to_dict")
                  else dict(config or {}),
        "format": CHECKPOINT_FORMAT,
    }
    _write_sidecar(path, meta)


def save_checkpoint(u, step: int, config, path, shape=None) -> None:
    """State dump + sidecar, committed crash-consistently. ``shape`` crops
    a padded grid to the domain.

    A ``ShardedGrid`` that spans processes is written per shard
    (``write_binary_sharded``'s collective, into the staging file), then
    process 0 commits it; the call is COLLECTIVE and no process returns
    before the commit, so a process that resumes at once never races a
    missing or stale pair."""
    if getattr(u, "spans_processes", False):
        from heat2d_tpu_torch.parallel.multihost import (barrier,
                                                         process_index)
        out_shape = tuple(shape) if shape is not None else (u.nx, u.ny)
        tmp = checkpoint_tmp_path(path)
        _write_blocks(u, tmp, *out_shape)
        if process_index() == 0:
            commit_checkpoint_files(tmp, path, step, config, out_shape)
        barrier()
        return
    a = _host_f32(u)
    if shape is not None and tuple(a.shape) != tuple(shape):
        a = a[:shape[0], :shape[1]]
    tmp = checkpoint_tmp_path(path)
    with open(tmp, "wb") as f:
        f.write(np.ascontiguousarray(a).tobytes())
    commit_checkpoint_files(tmp, path, step, config, a.shape)


def load_checkpoint(path, shape=None, verify: bool = True,
                    mmap: bool = False):
    """Returns (grid, step, config_dict). Without a sidecar (a raw
    ``final_binary.dat``) ``shape`` is required and step is 0. A sidecar's
    sha256 is verified unless ``verify`` is False; a mismatch, truncation
    or unreadable sidecar raises ``CheckpointCorruptError``.

    ``mmap=True`` digests the file in chunks and returns the grid as a
    read-only ``np.memmap``: a process that places only its own shards
    (``interop.sharded_from_numpy``) then reads only their rows, and no
    process holds the global grid in memory."""
    meta_path = str(path) + ".meta.json"
    if not os.path.exists(meta_path):
        if shape is None:
            raise ValueError(
                f"no sidecar at {meta_path}; pass shape= explicitly")
        return read_binary(path, shape), 0, {}
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        meta_shape = tuple(meta["shape"])
        step = int(meta["step"])
        digest = meta.get("sha256")
    except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
        raise CheckpointCorruptError(f"{path}: {e}") from e
    expected = int(np.prod(meta_shape))
    try:
        if mmap:
            buf = None
            size = os.path.getsize(path)
            actual = (_sha256_file(path) if verify and digest is not None
                      else None)
        else:
            with open(path, "rb") as f:
                buf = f.read()
            size = len(buf)
            actual = (hashlib.sha256(buf).hexdigest()
                      if verify and digest is not None else None)
    except OSError as e:
        raise CheckpointCorruptError(f"{path}: {e}") from e
    if actual is not None and actual != digest:
        raise CheckpointCorruptError(
            f"{path}: sha256 mismatch (sidecar {digest[:12]}…, "
            f"file {actual[:12]}…) — torn or corrupt checkpoint")
    if size != 4 * expected:
        raise CheckpointCorruptError(
            f"{path}: expected {expected} float32 values for shape "
            f"{meta_shape}, found {size // 4}")
    if mmap:
        grid = np.memmap(path, dtype=np.float32, mode="r", shape=meta_shape)
    else:
        grid = np.frombuffer(buf, dtype=np.float32).reshape(
            meta_shape).copy()
    return grid, step, meta.get("config", {})


def _write_sidecar(path, meta: dict) -> None:
    """The ``.meta.json`` of ``path``, staged, fsync'd and promoted, then
    the directory fsync'd."""
    meta_path = str(path) + ".meta.json"
    meta_tmp = meta_path + ".tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(meta_tmp, meta_path)
    _fsync_path(os.path.dirname(os.path.abspath(str(path))))


def save_field(a, path, name: str = "field", extra=None) -> None:
    """An auxiliary field (numpy array or tensor) as a raw binary and a
    digest sidecar (shape, dtype, sha256, ``name`` and any ``extra``
    keys), committed as a checkpoint is: staged to ``path + '.tmp'``,
    digested, promoted, then the sidecar the same way. ``load_field``
    verifies the digest, so a torn copy never loads."""
    a = _host(a)
    dtype = "bool" if a.dtype == np.bool_ else str(a.dtype)
    if dtype not in FIELD_DTYPES:
        raise ValueError(
            f"field dtype must be one of {FIELD_DTYPES}, got {a.dtype}")
    raw = a.astype(np.uint8) if dtype == "bool" else a
    tmp = checkpoint_tmp_path(path)
    raw.tofile(tmp)
    digest = _sha256_file(tmp)
    _fsync_path(tmp)
    os.replace(tmp, path)
    _write_sidecar(path, {
        "format": FIELD_FORMAT,
        "name": str(name),
        "shape": [int(s) for s in a.shape],
        "dtype": dtype,
        "sha256": digest,
        **(dict(extra) if extra else {}),
    })


def load_field(path, verify: bool = True):
    """A field saved by ``save_field`` (by either stack). Returns ``(array,
    meta)``; a digest mismatch, a truncated binary or an unreadable
    sidecar raises ``CheckpointCorruptError`` (``verify=False`` skips the
    digest check)."""
    meta_path = str(path) + ".meta.json"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        shape = tuple(int(s) for s in meta["shape"])
        dtype = str(meta["dtype"])
        digest = meta.get("sha256")
    except (OSError, json.JSONDecodeError, KeyError, ValueError,
            TypeError) as e:
        raise CheckpointCorruptError(f"{path}: {e}") from e
    if dtype not in FIELD_DTYPES:
        raise CheckpointCorruptError(
            f"{path}: sidecar dtype {dtype!r} not in {FIELD_DTYPES}")
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise CheckpointCorruptError(f"{path}: {e}") from e
    if verify and digest is not None:
        actual = hashlib.sha256(buf).hexdigest()
        if actual != digest:
            raise CheckpointCorruptError(
                f"{path}: sha256 mismatch (sidecar {digest[:12]}…, file "
                f"{actual[:12]}…) — torn or corrupt field file")
    a = np.frombuffer(buf, dtype=np.uint8 if dtype == "bool"
                      else np.dtype(dtype))
    expected = int(np.prod(shape)) if shape else 1
    if a.size != expected:
        raise CheckpointCorruptError(
            f"{path}: expected {expected} {dtype} values for shape "
            f"{shape}, found {a.size}")
    a = a.reshape(shape).copy()
    if dtype == "bool":
        a = a.astype(np.bool_)
    return a, meta
