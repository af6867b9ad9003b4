"""One run of one cell: set up, measure, check, report.

A cell is found by its name alone, from files:

- ``workloads/<cell>.json``: its configuration, traffic mix, chips, why,
  the limits of its checks, and under ``traffic_params`` the parameters
  of the mix that belong to this cell alone (an open loop's rate);
- ``configs/<config>.json``: the configuration's sizes, as run;
- ``traffic/<traffic>.json``: the mix's parameters and the ``driver``
  that generates it;
- ``drivers/<driver>.py``: the generator, a class ``Driver`` (below);
- ``metrics/<metric>.py``: one reader per per-layer metric, a function
  ``read(ctx)`` that returns the value, ``(value, note)``, or None when
  the cell has nothing for it to read.

A ``Driver(cell, seed, devices)`` has ``setup()`` (build and warm
the cell's own shapes), ``window(seconds, capture)`` (measure; returns
the end-to-end metrics and the counts), ``release()`` (drop the
program's state), ``check()`` (the comparison with the plain reference:
``{name: value}`` for each number its cell file gives a limit) and
``layer_ctx()`` (what the per-layer readers read besides the trace).

``run_cell`` does the run; ``run.py`` looks for the cards and calls it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: Top-level module names that no run may have loaded: the JAX stack and
#: the JAX package the program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "heat2d_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    why: str
    limits: dict
    check: dict
    trace: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell named ``name``, from its files under ``root``."""
    w = _json(root / "workloads" / f"{name}.json")
    return Cell(name=name, config_name=w["config"],
                config=_json(root / "configs" / f"{w['config']}.json"),
                traffic_name=w["traffic"],
                traffic=dict(_json(root / "traffic" / f"{w['traffic']}.json"),
                             **w.get("traffic_params", {})),
                chips=int(w["chips"]), why=w["why"],
                limits=dict(w["limits"]), check=dict(w.get("check", {})),
                trace=dict(w.get("trace", {})))


def _load_module(path: Path, prefix: str):
    mod_name = f"portbench_{prefix}_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(name: str, root: Path = HERE):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return _load_module(root / "drivers" / f"{name}.py", "driver").Driver


def metric_readers(root: Path = HERE) -> dict:
    """{metric name: its reader module} for every ``metrics/<name>.py``:
    ``read(ctx)`` and ``UNIT``."""
    return {path.name[:-3]: _load_module(path, "metric")
            for path in sorted((root / "metrics").glob("*.py"))
            if not path.name.startswith("_")}


def forbidden_loaded(modules=None) -> list:
    """The top-level names in ``modules`` (default ``sys.modules``) that
    are forbidden, compared whole: ``heat2d_tpu_torch`` is not
    ``heat2d_tpu``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def cache_environment(checkout: Path) -> dict:
    """Fixed directories inside the checkout for every build and kernel
    cache a run may touch (the program builds its kernels into
    ``build/kernels`` of the checkout by itself)."""
    base = checkout / "build" / "portbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def prepare_environment(checkout: Path) -> None:
    """Before torch is imported: the caches inside the checkout, and none
    of the program's switches that would change what it runs (a tuning
    db, armed tracing, a chaos hook)."""
    os.environ.update(cache_environment(checkout))
    for key in list(os.environ):
        if key.startswith(("HEAT2D_",)):
            del os.environ[key]
    os.environ["USE_FLAX"] = "0"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(devices) -> dict:
    """The ``device`` block: platform, kind, count and the fullest
    card's peak of allocated memory."""
    import torch
    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in devices)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             root: Path = HERE, cell: Cell | None = None,
             on_driver=None) -> dict:
    """One run of cell ``name``: returns the result line's object.
    ``device="cpu"`` runs the program's plain versions (how the tests
    drive a whole run without a card); ``cell`` replaces the cell's
    files (a test's small sizes); ``on_driver(driver)`` is called once
    the driver is made (a test's fault)."""
    import torch

    from portbench import trace_digest, yardstick

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root) if cell is None else cell
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for d in devices:
            # the allocator's statistics exist once the device holds memory
            torch.zeros(1, device=d)
            torch.cuda.reset_peak_memory_stats(d)
    else:
        devices = [torch.device(device)]
    drv = driver_class(cell.traffic["driver"], root)(cell, seed, devices)
    if on_driver is not None:
        on_driver(drv)
    capture = (trace_digest.Capture(on_card=device == "cuda")
               if trace else None)
    drv.setup()
    if capture is not None:
        capture.warm()
    if device == "cuda":
        for d in devices:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds, capture)
    drv.release()
    dev_block = device_info(devices)

    checks = drv.check()
    # a number the check could not read (a missing answer) fails
    compared = {k: {"value": float(checks.get(k, math.inf)),
                    "limit": float(lim)}
                for k, lim in cell.limits.items()}
    correct = (win["unanswered"] == 0 and win.get("errors", 0) == 0
               and all(v["value"] <= v["limit"]
                       for v in compared.values()))

    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"])}
    if not trace:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in win["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        result["metrics"] = metrics
        result["device"] = dev_block
    else:
        events = capture.load() if capture.started else []
        dig = (trace_digest.digest(events, len(devices)) if events
               else None)
        ctx = dict(drv.layer_ctx(), digest=dig, n_devices=len(devices),
                   peaks=yardstick.peaks_for(dev_block["kind"]))
        metrics = {}
        for mname, reader in metric_readers(root).items():
            got = reader.read(ctx)
            if got is None:
                continue
            value, note = got if isinstance(got, tuple) else (got, None)
            if value is None or not math.isfinite(value):
                continue
            metrics[mname] = {"value": value, "unit": reader.UNIT}
            if note:
                _log(f"{mname}: {note}")
        result["metrics"] = metrics
        if dig is not None:
            dev_block["busy_s"] = (sum(dig["busy_s"].values())
                                   / len(devices))
            dev_block["window_s"] = dig["window_s"]
            result["breakdown"] = {"device_ops": dig["device_ops"],
                                   "idle_gaps": dig["idle_gaps"]}
        result["device"] = dev_block
    result["checks"] = compared
    found = forbidden_loaded()
    if found:
        raise ForbiddenModules(found)
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("modules loaded that no run may load: "
                         + ", ".join(found))
        self.found = found
