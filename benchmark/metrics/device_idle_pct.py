"""The share of the profiled scenes' wall in which no kernel, copy or set
ran on the card (telemetry off, so no stage waits for the card)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
