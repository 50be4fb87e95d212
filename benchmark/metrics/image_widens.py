"""The host's float32 copies of a scene (``Image.img_data`` widening a
narrow source array on its first read): the mean a scene of the program's
telemetry counter ``image.widen``, over the traced run's scenes with the
telemetry on."""


def read(ctx):
    rec = ctx["stages"].get("image.widen")
    if not rec or not ctx["stage_scenes"]:
        return None
    return rec["total"] / ctx["stage_scenes"]
