"""The GLCM pre-pass (``bbox_minmax``: every object's box and each band's range): the mean milliseconds a scene spent in the
program's telemetry stage ``glcm.prepass``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("glcm.prepass")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
