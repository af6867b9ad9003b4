"""The port's hand-kernel calls sent to a library that records them: the
card's side of a wrapper, run on a machine without a card."""


def record_launches(monkeypatch) -> list:
    """Send every ``heat2d_tpu_torch.ops._build.call`` to a library that
    records it and returns 0, a launch on stream 7: the list of (entry,
    args), filled as the calls come. Tensors on the CPU plan for the H100
    (``_build.device_caps``)."""
    from heat2d_tpu_torch.ops import _build
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0
    monkeypatch.setattr(_build, "load", lambda library: Lib())
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "_stream", lambda device: 7)
    return calls
