"""The traced run's capture and its reduction to numbers.

``Capture`` profiles a slice of the measured window with
``torch.profiler`` (host and CUDA activity) and marks it with the range
``portbench.slice``: ``start`` and ``stop`` on one thread, ``load``
after the window, which writes the Chrome trace to a directory under
``TMPDIR``, reads it and deletes it. ``digest`` reduces the events to
what the per-layer metrics and the result's ``breakdown`` read: per card,
the device's busy time inside the slice; the kernels' time; the device
operations by name; the longest idle gaps with what the host was doing;
the work spans (``portbench.work:<updates>:<flops>:<bytes>``) the
drivers mark, weighted by how much of each lies inside the slice.

The interval arithmetic (merging a lane's busy intervals, the gaps
between them, the hand kernels' labels) is the program's own trace
digest's (``obs/trace_report.py``), copied here so that the yardstick
does not move with the program.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import tempfile
import time

#: Chrome-trace categories of the device's own events.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host categories a gap's label is read from.
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")

SLICE = "portbench.slice"
#: Seconds between the profiler's start and the slice's: what starting
#: it costs stays outside the slice.
SETTLE_S = 0.2
WORK = "portbench.work"

#: Hand kernel base name -> its label, or (the label when the template
#: argument at that index is true, the label when false, the index).
KERNEL_LABELS = {
    "k_step": "H1",
    "k_tile": ("H3", "H2", 1),
    "k_resident": "H4",
    "k_ens_resident": "H5",
    "k_ens_tile": ("H7", "H6", 0),
    "k_fam_resident": "H8",
    "k_fam_tile": "H9",
    "k_td_rows": "H10",
    "k_td_lanes": "H11",
    "k_td_coeffs": "td_coeffs",
    "k_shard_tile": ("H13", "H12", 1),
    "k_shard_fused": "H14",
}
_KERNEL_NAME = re.compile(r"(?<![A-Za-z0-9_])(k_[a-z_]+)\b")


def _template_args(name: str, at: int) -> list:
    while at < len(name) and name[at] == " ":
        at += 1
    if at >= len(name) or name[at] != "<":
        return []
    out, depth, cur = [], 0, ""
    for ch in name[at:]:
        if ch == "<":
            depth += 1
            if depth == 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth == 0:
                break
        if ch == "," and depth == 1:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    out.append(cur.strip())
    return out


def kernel_label(name: str):
    """The hand kernel's label (H1-H14) of a demangled name, or None."""
    for m in _KERNEL_NAME.finditer(name):
        spec = KERNEL_LABELS.get(m.group(1))
        if spec is None:
            continue
        if isinstance(spec, str):
            return spec
        on, off, i = spec
        args = _template_args(name, m.end())
        return on if i < len(args) and args[i] in ("true", "1",
                                                    "(bool)1") else off
    return None


def op_name(e: dict) -> str:
    """A device event's short name: the hand kernel's label and base
    name, or the first 60 characters of the name."""
    name = e.get("name", "")
    if e.get("cat") == "kernel":
        label = kernel_label(name)
        if label is not None:
            return f"{label} {_KERNEL_NAME.search(name).group(1)}"
    return name[:60]


def merge(ivals) -> list:
    """Union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(a: float, b: float, lo: float, hi: float) -> float:
    return max(0.0, min(b, hi) - max(a, lo))


class Capture:
    """A profiled slice: ``start`` and ``stop`` on one thread (the range
    ``portbench.slice`` opens and closes there), then ``load`` once the
    window has closed."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.events: list = []
        self._prof = self._range = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        try:
            # every thread's host events (a server's scheduler thread
            # launches its work), where the profiler offers it
            from torch._C._profiler import _ExperimentalConfig
            cfg = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            cfg = None
        return profile(activities=acts, experimental_config=cfg)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracing, which holds the card's callers
        up for about a second."""
        import torch
        with self._profile():
            torch.zeros(1, device="cuda" if self.on_card else "cpu").add_(1)

    def start(self) -> None:
        import torch
        self._prof = self._profile()
        self._prof.__enter__()
        time.sleep(SETTLE_S)
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self) -> None:
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    @property
    def started(self) -> bool:
        return self._prof is not None

    def load(self) -> list:
        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(tmp, "slice.pt.trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return self.events


def _device_of(e: dict):
    args = e.get("args") or {}
    return str(args.get("device", e.get("pid")))


def digest(events: list, n_devices: int, top: int = 10) -> dict:
    """Reduce a capture's events to the slice's numbers (see the module
    docstring). Times are in seconds; ``n_devices`` is the number of
    cards the run uses (a card with no event inside the slice was idle
    through it)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    sl = [e for e in xs if e.get("name") == SLICE
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise ValueError(f"the capture holds no {SLICE} range")
    lo = sl[0]["ts"]
    hi = lo + sl[0].get("dur", 0)
    span = hi - lo

    device = [e for e in xs if e.get("cat") in DEVICE_CATS
              and e.get("dur", 0) > 0]
    busy_by_dev = collections.defaultdict(list)
    by_op = collections.defaultdict(float)
    kernel_us = 0.0
    for e in device:
        a, b = e["ts"], e["ts"] + e["dur"]
        d = _clip(a, b, lo, hi)
        if d <= 0:
            continue
        busy_by_dev[_device_of(e)].append((max(a, lo), min(b, hi)))
        by_op[op_name(e)] += d
        if e["cat"] == "kernel":
            kernel_us += d

    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e.get("name") != SLICE]
    gaps = []
    busy_us = {}
    for i in range(n_devices):
        merged = merge(busy_by_dev.get(str(i), []))
        busy_us[i] = sum(b - a for a, b in merged)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for k in range(0, len(edges), 2):
            if edges[k + 1] > edges[k]:
                gaps.append((edges[k + 1] - edges[k], edges[k], i))
    gaps.sort(reverse=True)
    idle_gaps = [[f"card{i}: {host_label(host, t0 + d / 2)}", d / 1e6]
                 for d, t0, i in gaps[:top]]

    work = {"updates": 0.0, "flops": 0.0, "bytes": 0.0}
    for e in xs:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or not name.startswith(
                WORK + ":"):
            continue
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        frac = (_clip(a, b, lo, hi) / (b - a)) if b > a else 0.0
        _, upd, fl, by = name.split(":")
        work["updates"] += frac * float(upd)
        work["flops"] += frac * float(fl)
        work["bytes"] += frac * float(by)

    return {
        "window_s": span / 1e6,
        "busy_s": {i: busy_us[i] / 1e6 for i in range(n_devices)},
        "idle_pct": {i: (100.0 * (span - busy_us[i]) / span
                         if span > 0 else None) for i in range(n_devices)},
        "kernel_s": kernel_us / 1e6,
        "device_op_s": sum(by_op.values()) / 1e6,
        "device_ops": [[n, s / 1e6] for n, s in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": idle_gaps,
        "work": work,
    }


def host_label(host: list, t: float) -> str:
    """What the host was doing at ``t``: the names of the host events
    open then, outermost first, the innermost three."""
    hits = sorted((e["ts"], -e.get("dur", 0), e["name"]) for e in host
                  if e["ts"] <= t <= e["ts"] + e.get("dur", 0))
    names = [n for *_, n in hits]
    return " > ".join(names[-3:]) if names else "nothing traced"
