"""The detector's RetinaNet's forward pass on the card (the padded float32 input made before it): the mean milliseconds a scene of the program's
telemetry stage ``detect.forward``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = (ctx.get("stages") or {}).get("detect.forward")
    if not rec or not ctx.get("stage_scenes"):
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
