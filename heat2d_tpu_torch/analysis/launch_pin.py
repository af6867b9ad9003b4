"""The port's "free when off" pins: the counterpart of
``heat2d_tpu/analysis/jaxpr_pin.py``.

The JAX package proves that a subsystem costs nothing on the compiled
path by tracing a program with the subsystem armed and again without it
and asserting the two jaxprs are byte-identical. The port has no traced
program to compare (its kernels are launched eagerly), so its pin
compares what a run DOES, armed against disarmed:

- the route the runner took and its host reads of the residual
  (``residual_reads``), and ``steps_done``;
- the result's bits (its sha256);
- on the card, the hand kernels' launches (every wrapper's ``LAUNCHES``
  counter; the plain versions on the CPU count nothing, so there this
  part is vacuous and the card's tests hold it).

Three pins:

- ``pin_chaos``: a chaos campaign armed with nothing due (no kill, no
  failure reaches this run) against none;
- ``pin_lock_audit``: the lock auditor installed against not (and the
  audit itself clean);
- ``pin_checkpoint_every``: the solver CLI with ``--checkpoint DIR/
  --checkpoint-every K`` against the same CLI run unsegmented: a
  bitwise equal grid, the same route, and per segment the kernel
  sequence of a run of the segment's length (its warmup included, once
  per distinct length) and nothing else.
"""

from __future__ import annotations

import contextlib
import difflib
import hashlib
import io
import json
import os
from typing import Optional


def launch_counts() -> dict:
    """Every hand-kernel wrapper's launch count, by wrapper name."""
    from heat2d_tpu_torch.ops import (cuda_ensemble, cuda_family, cuda_shard,
                                      cuda_stencil, tridiag)
    out = {}
    for mod in (cuda_stencil, cuda_ensemble, cuda_family, cuda_shard,
                tridiag):
        out.update(mod.launch_counts())
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _sha(u) -> str:
    import numpy as np

    from heat2d_tpu_torch.parallel.multihost import gather_to_host
    return hashlib.sha256(np.ascontiguousarray(
        gather_to_host(u), dtype=np.float32).tobytes()).hexdigest()


def solver_fingerprint(cfg, device=None, devices=None) -> dict:
    """One untimed run of ``Heat2DSolver(cfg)``: its route, residual
    reads, steps_done, the result's sha256 and the launches it made."""
    from heat2d_tpu_torch.models.solver import Heat2DSolver
    before = launch_counts()
    r = Heat2DSolver(cfg, device=device, devices=devices).run(timed=False)
    return {"route": r.route, "residual_reads": r.residual_reads,
            "steps_done": r.steps_done, "sha256": _sha(r.u),
            "launches": _delta(before, launch_counts())}


def diff_fingerprints(a: dict, b: dict, label_a: str = "off",
                      label_b: str = "on") -> str:
    """A unified diff of two fingerprints' JSON, key by key."""
    def lines(d):
        return json.dumps(d, indent=1, sort_keys=True).splitlines()
    return "\n".join(difflib.unified_diff(lines(a), lines(b), label_a,
                                          label_b, lineterm=""))


def assert_same(a: dict, b: dict, label: str = "run") -> None:
    """The two fingerprints are equal, or an AssertionError with their
    diff."""
    if a != b:
        raise AssertionError(f"{label}: armed and disarmed runs differ:\n"
                             f"{diff_fingerprints(a, b)}")


def assert_differs(a: dict, b: dict, label: str = "run") -> None:
    """Non-vacuity twin: two runs expected to differ do (pinning two
    copies of the same thing to each other proves nothing)."""
    if a == b:
        raise AssertionError(f"{label}: the runs are identical but were "
                             f"expected to differ: the pin is vacuous")


def pin_chaos(cfg, device=None, devices=None) -> dict:
    """A chaos campaign armed with nothing due against none."""
    from heat2d_tpu_torch.resil import chaos
    chaos.uninstall()
    off = solver_fingerprint(cfg, device, devices)
    chaos.install(chaos.ChaosConfig(kill_ckpt_at=10 ** 9,
                                    device_fail_at=10 ** 9,
                                    flip_bit=10 ** 9))
    try:
        assert chaos.enabled()
        on = solver_fingerprint(cfg, device, devices)
    finally:
        chaos.uninstall()
    assert_same(off, on, "chaos armed vs disarmed")
    return {"off": off, "on": on}


def pin_lock_audit(cfg, device=None, devices=None) -> dict:
    """The lock auditor installed against not; the audit clean."""
    from heat2d_tpu_torch.analysis import locks
    off = solver_fingerprint(cfg, device, devices)
    locks.install()
    try:
        on = solver_fingerprint(cfg, device, devices)
        report = locks.report()
    finally:
        locks.uninstall()
    assert_same(off, on, "lock audit on vs off")
    if not report.clean:
        raise AssertionError(report.render())
    return {"off": off, "on": on}


def _cli(argv) -> int:
    from heat2d_tpu_torch.cli import main
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _cli_fingerprint(cfg, device, outdir, extra) -> dict:
    os.makedirs(outdir, exist_ok=True)
    rec = os.path.join(outdir, "rec.json")
    argv = ["--device", str(device or "cuda"), "--mode", cfg.mode,
            "--nxprob", str(cfg.nxprob), "--nyprob", str(cfg.nyprob),
            "--steps", str(cfg.steps), "--cx", repr(cfg.cx), "--cy",
            repr(cfg.cy), "--dat-layout", "none", "--binary-dumps",
            "--outdir", outdir, "--run-record", rec]
    if cfg.convergence:
        argv += ["--convergence", "--interval", str(cfg.interval),
                 "--sensitivity", repr(cfg.sensitivity)]
    before = launch_counts()
    rc = _cli(argv + list(extra))
    if rc != 0:
        raise AssertionError(f"cli {argv + list(extra)} exited {rc}")
    launches = _delta(before, launch_counts())
    with open(rec) as f:
        record = json.load(f)
    with open(os.path.join(outdir, "final_binary.dat"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"route": record["route"],
            "residual_reads": record["residual_reads"],
            "steps_done": record["steps_done"], "sha256": digest,
            "launches": launches,
            "checkpoints_written": record.get("checkpoints_written")}


def pin_checkpoint_every(cfg, k: int, workdir, device=None) -> dict:
    """``--checkpoint DIR/ --checkpoint-every k`` against none, through
    the solver CLI. Equal: the grid's bits, the route, the residual
    reads and steps_done; the segmented run's launches are those of its
    segments (one run of each segment's length, plus one warmup run per
    distinct length), measured here by solver runs of those lengths, so
    a snapshot or a re-warmup that launched a kernel would show. On a
    convergence config the launches are not pinned (a segment's
    launches depend on its state)."""
    off = _cli_fingerprint(cfg, device, os.path.join(workdir, "off"), [])
    on = _cli_fingerprint(
        cfg, device, os.path.join(workdir, "on"),
        ["--checkpoint", os.path.join(workdir, "ck") + os.sep,
         "--checkpoint-every", str(k), "--checkpoint-keep", "0"])
    n_segments = -(-cfg.steps // k)
    if on["checkpoints_written"] != max(n_segments, 1) and \
            not cfg.convergence:
        raise AssertionError(f"{on['checkpoints_written']} checkpoints "
                             f"written for {n_segments} segments")
    expected: Optional[dict] = None
    if not cfg.convergence:
        lengths = [min(k, cfg.steps - s) for s in range(0, cfg.steps, k)]
        per = {n: solver_fingerprint(cfg.replace(steps=n), device)
               ["launches"] for n in set(lengths)}
        expected = {}
        for n in lengths + sorted(set(lengths)):   # runs, then warmups
            for name, c in per[n].items():
                expected[name] = expected.get(name, 0) + c
        if on["launches"] != expected:
            raise AssertionError(
                f"segmented launches {on['launches']} are not its "
                f"segments' {expected}")
    keys = ("route", "residual_reads", "steps_done", "sha256")
    assert_same({key: off[key] for key in keys},
                {key: on[key] for key in keys},
                "--checkpoint-every vs none")
    return {"off": off, "on": on, "expected_launches": expected}
