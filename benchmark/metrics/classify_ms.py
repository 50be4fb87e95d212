"""The classify tail (the training table, then the forest's predict, or the MLP's fit and predict): the mean milliseconds a scene spent in the
benchmark's own span ``classify``, over the traced run's scenes with the
telemetry on."""


def read(ctx):
    spans = ctx["spans"].get("classify")
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)
