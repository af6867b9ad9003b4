"""The readers of the program's own spans: the counters its hook
(``heat2d_tpu_torch.utils.profiling.phase``) keeps in the process
registry, ``trace_spans_total{span=}`` and
``trace_span_seconds_total{span=}``. The hook counts only while a
profiler records, so in a traced run they cover the traced slice. A
program without these counters leaves every reader empty."""


def spans() -> dict:
    """{span name: (entries, host seconds)}; empty where the program
    keeps no such counters."""
    try:
        from heat2d_tpu_torch.obs import get_registry
        reg = get_registry()
        counts = reg.find_counters("trace_spans_total")
        secs = reg.find_counters("trace_span_seconds_total")
    except (ImportError, AttributeError):
        return {}
    out = {}
    for labels, n in counts.items():
        name = dict(labels).get("span")
        if name is not None:
            out[name] = (n, secs.get(labels, 0.0))
    return out


def seconds(got: dict, names) -> float:
    return sum(got.get(n, (0, 0.0))[1] for n in names)


def count(got: dict, name: str) -> float:
    return got.get(name, (0, 0.0))[0]


def shares(got: dict, names, per: float, scale: float, unit: str) -> str:
    """Each span's seconds over ``per`` entries (x ``scale``, in
    ``unit``) and its share of their sum."""
    total = seconds(got, names)
    parts = []
    for n in names:
        s = got.get(n, (0, 0.0))[1]
        pct = 100.0 * s / total if total > 0 else 0.0
        parts.append(f"{n} {scale * s / per:.6g} {unit} ({pct:.3g}%)")
    return ", ".join(parts)
