"""The texture features (the bounding-box pre-pass and glcm_sums): the mean milliseconds a scene spent in the
program's telemetry stage ``objects.glcm``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("objects.glcm")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
