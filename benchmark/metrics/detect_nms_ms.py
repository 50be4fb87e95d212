"""The detector's greedy per-class NMS of the candidates on the host, and the clip: the mean milliseconds a scene of the program's
telemetry stage ``detect.nms``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = (ctx.get("stages") or {}).get("detect.nms")
    if not rec or not ctx.get("stage_scenes"):
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
