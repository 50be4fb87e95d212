"""Segmentation (normalise, SLIC or quickshift, connected components, merge): the mean milliseconds a scene spent in the
program's telemetry stage ``segment.kernel``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("segment.kernel")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
