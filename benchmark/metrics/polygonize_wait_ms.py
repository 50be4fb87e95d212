"""How long a scene waited, at its end, for the polygonisation thread: the mean milliseconds a scene spent in the
benchmark's own span ``polygonize_wait``, over the traced run's scenes with the
telemetry on."""


def read(ctx):
    spans = ctx["spans"].get("polygonize_wait")
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)
