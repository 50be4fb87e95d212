"""The forest's predict on the card (``forest_proba``): the mean milliseconds a scene spent in the
program's telemetry stage ``forest.predict``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("forest.predict")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
