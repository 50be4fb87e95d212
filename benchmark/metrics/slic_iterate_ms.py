"""SLIC's k-means loop (``ops/slic._slic_iterate``: every assignment and
centre update, before connectivity): the mean milliseconds a scene spent in
the program's telemetry stage ``slic.iterate``, over the traced run's scenes
with the telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("slic.iterate")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
