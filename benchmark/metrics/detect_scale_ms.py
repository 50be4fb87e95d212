"""The detector's the raster's upload and its global min-max scaling to uint8 in float64 on the card: the mean milliseconds a scene of the program's
telemetry stage ``detect.scale``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = (ctx.get("stages") or {}).get("detect.scale")
    if not rec or not ctx.get("stage_scenes"):
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
