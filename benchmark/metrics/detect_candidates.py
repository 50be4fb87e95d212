"""The boxes that pass the detector's score filter into NMS: the mean a
scene of the program's telemetry counter ``detect.candidates``, over the
traced run's scenes with the telemetry on."""


def read(ctx):
    rec = (ctx.get("stages") or {}).get("detect.candidates")
    if not rec or not ctx.get("stage_scenes"):
        return None
    return rec["total"] / ctx["stage_scenes"]
