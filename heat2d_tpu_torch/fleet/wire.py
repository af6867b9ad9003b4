"""Fleet wire protocol: JSON lines over a worker's stdio pipe. The port's
copy of ``heat2d_tpu/fleet/wire.py``, the same protocol name and keys, so
that a line written by either stack parses in the other with the grid
bit for bit.

One JSON object per line, both directions. The supervisor writes
request envelopes and control events to a worker's stdin; the worker
writes responses and liveness events to stdout. Grids travel as base64
of their raw bytes: a text protocol keeps the framing debuggable and
crash-safe (a worker killed mid-line leaves one torn line, which the
reader skips, never a desynchronized binary stream).

supervisor -> worker::

    {"id": 7, "req": {...SolveRequest.spec()...},
     "trace": {"trace_id": "...", "span_id": "..."}}   # optional
    {"id": 8, "event": "warmup", "req": {...}}         # warm restart
    {"event": "shutdown"}              # drain and exit 0

``trace`` is the optional tracing context of the router's dispatch span
(``obs/tracing.py``): a worker parents its serving spans on it. It is
envelope-level and never enters the request spec, so it cannot perturb
content hashes or batch buckets.

worker -> supervisor::

    {"event": "ready", "pid": 1234, "worker": 0, "protocol": "..."}
    {"event": "hb", "worker": 0}       # periodic heartbeat
    {"id": 7, "ok": true,  ...encode_result fields...}
    {"id": 7, "ok": false, "rejected": {...Rejected.to_record()...}}

The port's worker adds keys the JAX supervisor ignores (it reads lines
with ``msg.get``): the ready line's ``startup`` (when the process
reached each stage of its start, on the host's monotonic clock) and the
heartbeat's ``launches`` (the hand kernels' launch counts in that
process, so that a caller can show the pool went through them).

``id`` is unique per dispatch (a replayed request gets a fresh one), so
a late line from a fenced worker can never be taken for the replay's
answer.
"""

from __future__ import annotations

import base64
import json

from heat2d_tpu_torch.serve.schema import Rejected, SolveResult

PROTOCOL = "heat2d-tpu/fleet-wire/v1"


def decode_trace(msg: dict):
    """The dispatch line's tracing context, or None: malformed and absent
    are the same non-event."""
    from heat2d_tpu_torch.obs.tracing import TraceContext
    return TraceContext.from_wire(msg.get("trace"))


def _result_head(rid: int, res: SolveResult, u) -> dict:
    return {
        "id": rid, "ok": True,
        "steps_done": int(res.steps_done),
        "content_hash": res.content_hash,
        "batch_size": int(res.batch_size),
        "worker_cache_hit": bool(res.cache_hit),
        "u_shape": [int(d) for d in u.shape],
        "u_dtype": str(u.dtype),
    }


def encode_result(rid: int, res: SolveResult) -> dict:
    import numpy as np
    u = np.ascontiguousarray(np.asarray(res.u))
    return {**_result_head(rid, res, u),
            "u_b64": base64.b64encode(u.tobytes()).decode("ascii")}


def result_line(rid: int, res: SolveResult) -> bytes:
    """``encode_result`` as one wire line (UTF-8, newline included) whose
    ``json.loads`` equals ``encode_result(rid, res)``, built without
    JSON's escape scan over the base64 text (its alphabet needs none). A
    4096^2 grid's line is ~89 MB, which ``json.dumps`` scans for about a
    second holding the GIL, beside the worker's heartbeat thread."""
    import numpy as np
    u = np.ascontiguousarray(np.asarray(res.u))
    head = json.dumps(_result_head(rid, res, u))
    return b"".join((head[:-1].encode(), b', "u_b64": "',
                     base64.b64encode(u.tobytes()), b'"}\n'))


def decode_result(msg: dict) -> SolveResult:
    """The worker's answer as a ``SolveResult``; ``u`` is a read-only numpy
    view over the decoded bytes (results are immutable: the fleet cache
    shares them across callers)."""
    import numpy as np
    u = np.frombuffer(base64.b64decode(msg["u_b64"]),
                      dtype=msg["u_dtype"]).reshape(msg["u_shape"])
    return SolveResult(u=u, steps_done=int(msg["steps_done"]),
                       content_hash=msg["content_hash"],
                       batch_size=int(msg.get("batch_size", 1)))


def encode_rejection(rid: int, exc: BaseException) -> dict:
    if isinstance(exc, Rejected):
        return {"id": rid, "ok": False, "rejected": exc.to_record()}
    return {"id": rid, "ok": False,
            "rejected": {"rejected": "error", "message": repr(exc)}}


def decode_rejection(msg: dict) -> Rejected:
    d = dict(msg.get("rejected") or {})
    code = d.pop("rejected", "error")
    message = d.pop("message", "")
    return Rejected(code, message, **d)
