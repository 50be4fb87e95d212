"""The wait, at the join, for the polygonisation thread (``SegmentLayer.geometry``): the mean milliseconds a scene spent in the
program's telemetry stage ``segment.join``, over the traced run's scenes with the
telemetry on (host clock: it never waits for the card)."""


def read(ctx):
    rec = ctx["stages"].get("segment.join")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
