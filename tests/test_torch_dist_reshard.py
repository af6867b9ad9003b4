"""N-process save -> M-process restore of the port's dist worker, as
tests/test_dist_reshard.py pins the JAX package's.

A collective checkpoint commits the FULL grid through the same
crash-consistent one-file path as every other checkpoint
(``io/binary.py``), so the saving and restoring process counts are
independent: each restoring process loads the full grid and slices its
own slab (``dist/exchange.run_process_slab``'s ``u0``). Pinned BITWISE
both ways (2-save -> 1-restore, 1-save -> 2-restore) against an
uninterrupted one-process run. The 2-process legs are real worlds of the
worker CLI on the CPU (60 s timeout each); the 1-process legs run the
same CLI in this process. The checkpoints load in the JAX package too.
"""

import sys

import numpy as np
import pytest
import torch

from heat2d_tpu.io import load_checkpoint as jload_checkpoint
from heat2d_tpu_torch.dist import cli as dcli
from heat2d_tpu_torch.dist.exchange import run_process_slab
from heat2d_tpu_torch.dist.harness import spawn_world
from heat2d_tpu_torch.io.binary import load_checkpoint

NX, NY, SEG = 32, 24, 4
HALF, FULL = 8, 16
COMMON = ["--device", "cpu", "--nx", str(NX), "--ny", str(NY),
          "--segment", str(SEG)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn2(extra):
    results = spawn_world(
        2, lambda i, coord: [
            sys.executable, "-m", "heat2d_tpu_torch.dist.cli",
            "--coordinator", coord, "--num-processes", "2",
            "--process-id", str(i)] + COMMON + extra, timeout=60)
    assert all(r.ok for r in results), [r.output for r in results]


def _run1(extra):
    assert dcli.main(["--num-processes", "1"] + COMMON + extra) == 0


def _reference():
    ref, _ = run_process_slab(NX, NY, FULL, depth=SEG, device="cpu")
    return ref


def test_two_process_save_one_process_restore(tmp_path):
    ck = tmp_path / "ck.bin"
    out = tmp_path / "final.bin"
    _spawn2(["--steps", str(HALF), "--checkpoint", str(ck),
             "--checkpoint-every", str(SEG)])
    grid, step, cfg = load_checkpoint(str(ck))
    assert step == HALF and grid.shape == (NX, NY)
    assert cfg["processes"] == 2
    jgrid, jstep, _ = jload_checkpoint(str(ck))
    assert jstep == step and np.asarray(jgrid).tobytes() == grid.tobytes()

    _run1(["--steps", str(FULL), "--resume", str(ck), "--out", str(out)])
    got = np.fromfile(out, np.float32).reshape(NX, NY)
    assert got.tobytes() == _reference().tobytes()


def test_one_process_save_two_process_restore(tmp_path):
    ck = tmp_path / "ck.bin"
    out = tmp_path / "final.bin"
    _run1(["--steps", str(HALF), "--checkpoint", str(ck),
           "--checkpoint-every", str(SEG)])
    grid, step, cfg = load_checkpoint(str(ck))
    assert step == HALF and cfg["processes"] == 1

    _spawn2(["--steps", str(FULL), "--resume", str(ck), "--out", str(out)])
    got = np.fromfile(out, np.float32).reshape(NX, NY)
    assert got.tobytes() == _reference().tobytes()
