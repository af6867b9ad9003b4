"""The multi-process spawn/rendezvous/collect harness that the tests and
the ``heat2d-tpu-torch-dist`` launcher legs share. The port of
``heat2d_tpu/dist/harness.py``.

Two capabilities, probed separately as the JAX package probes them:

- **rendezvous**: the ``TCPStore`` at the coordinator (KV, barriers);
  the store halo route and every dist/ bring-up rides it;
- **collectives**: cross-process computation over the mesh (the port's
  sharded modes across processes: gloo sends, receives and gathers).

The JAX package's CPU backend cannot run cross-process computations,
so its collectives probe returns the backend's refusal there. The
port's runs over gloo, which does move tensors between processes on the
CPU (and, staged through the host, from cards), so here the probe
returns None wherever processes can rendezvous.

Each probe runs at most once per process (a module-level memo), spawns
REAL processes, and kills them on timeout with their output captured:
a probe must never hang the suite it protects. Every spawned world has
a timeout, on whose expiry all its children are killed.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

#: repo root: children run from here so ``-m heat2d_tpu_torch...``
#: resolves
REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: torchrun's and torch.distributed's variables, which a parent (itself a
#: rank of some world) would otherwise leak into a child world
_STRIP = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
          "LOCAL_WORLD_SIZE", "GROUP_RANK", "ROLE_RANK",
          "TORCHELASTIC_USE_AGENT_STORE", "TORCHELASTIC_RUN_ID")


def free_port() -> int:
    """A TCP port free on the loopback interface just now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(extra: Optional[dict] = None) -> dict:
    """The parent's environment minus the variables that would leak a
    world's identity into a child, with c10d's C++ warnings (such as "the
    hostname of the client socket cannot be retrieved") kept out of the
    output that callers parse, plus ``extra`` overrides."""
    env = {k: v for k, v in os.environ.items() if k not in _STRIP}
    env.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
    if extra:
        env.update(extra)
    return env


@dataclass
class ProcResult:
    process_id: int
    returncode: Optional[int]
    output: str          # stdout and stderr, merged

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def first_error_line(outputs: Sequence[str]) -> Optional[str]:
    """The distinguishing ``...Error:...`` line of a failed world's merged
    outputs: the reason a skip must surface."""
    for out in outputs:
        m = re.search(r"^.*(?:Error|error):.*$", out, re.MULTILINE)
        if m:
            return m.group(0).strip()[:200]
    return None


def spawn_world(num_processes: int,
                argv_fn: Callable[[int, str], List[str]], *,
                env: Optional[dict] = None,
                timeout: float = 180.0,
                cwd: str = REPO) -> List[ProcResult]:
    """Launch ``num_processes`` rendezvousing children and collect them:
    ``argv_fn(process_id, coordinator)`` builds each launch line (the
    mpiexec analogue: same program, different rank). One free port
    becomes ``127.0.0.1:<port>``; stdout and stderr are merged and
    captured; a world that outlives ``timeout`` seconds is killed whole.

    Returns per-process results in process-id order. A timeout marks
    returncode None, with whatever output made it out."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = clean_env() if env is None else env
    procs = [subprocess.Popen(
        argv_fn(i, coordinator), cwd=cwd, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(num_processes)]
    results: List[ProcResult] = []
    timed_out = False
    try:
        for i, p in enumerate(procs):
            try:
                out = p.communicate(
                    timeout=None if timed_out else timeout)[0]
                rc: Optional[int] = p.returncode
            except subprocess.TimeoutExpired:
                timed_out = True
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                out = p.communicate()[0]
                rc = None
            results.append(ProcResult(i, rc, out or ""))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    return results


# ------------------------------------------------------------------ #
# once-per-process capability probes
# ------------------------------------------------------------------ #

_memo: dict = {}


def rendezvous_unsupported_reason() -> Optional[str]:
    """None when a real 2-process store rendezvous and a KV round trip
    work here; otherwise the reason a rendezvous-needing test skips
    with."""
    if "rendezvous" in _memo:
        return _memo["rendezvous"]
    prog = (
        "import sys, datetime, torch.distributed as d\n"
        "host, port = sys.argv[1].rsplit(':', 1); me = int(sys.argv[2])\n"
        "s = d.TCPStore(host, int(port), 2, me == 0,"
        " timeout=datetime.timedelta(seconds=60))\n"
        "s.set('probe/%d' % me, 'up')\n"
        "s.wait(['probe/%d' % (1 - me)])\n"
        "assert s.get('probe/%d' % (1 - me)) == b'up'\n"
        "s.set('probe/fin', 'x') if me else s.wait(['probe/fin'])\n"
        "print('RENDEZVOUS_OK')\n")
    results = spawn_world(
        2, lambda i, coord: [sys.executable, "-c", prog, coord, str(i)],
        timeout=120)
    _memo["rendezvous"] = None if all(r.ok for r in results) else (
        first_error_line([r.output for r in results])
        or f"rendezvous probe exited {[r.returncode for r in results]}")
    return _memo["rendezvous"]


def collectives_unsupported_reason() -> Optional[str]:
    """None when a real 2-process cross-process computation runs here (a
    minimal dist2d step of the port's CLI over a (2, 1) mesh spanning
    both processes, on the CPU); otherwise the failed world's error
    line."""
    if "collectives" in _memo:
        return _memo["collectives"]
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        results = spawn_world(
            2, lambda i, coord: [
                sys.executable, "-m", "heat2d_tpu_torch.cli",
                "--mode", "dist2d", "--gridx", "2", "--gridy", "1",
                "--nxprob", "8", "--nyprob", "8", "--steps", "1",
                "--device", "cpu", "--coordinator", coord,
                "--num-processes", "2", "--process-id", str(i),
                "--dat-layout", "none", "--outdir", td],
            timeout=180)
    if all(r.ok for r in results):
        _memo["collectives"] = None
    elif any(r.returncode is None for r in results):
        _memo["collectives"] = "2-process probe timed out after 180s"
    else:
        _memo["collectives"] = (
            first_error_line([r.output for r in results])
            or f"probe exited {[r.returncode for r in results]} with "
               f"no recognizable error line")
    return _memo["collectives"]
