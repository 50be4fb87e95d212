"""The detector's the GeoTIFF read through io/tiff.TiffReader, on the host: the mean milliseconds a scene of the program's
telemetry stage ``detect.read``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = (ctx.get("stages") or {}).get("detect.read")
    if not rec or not ctx.get("stage_scenes"):
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
