"""The scene's uploads to the card (``Image.device_tensor`` on a cache
miss, one a device): the mean a scene of the program's telemetry counter
``image.uploads``, over the traced run's scenes with the telemetry on."""


def read(ctx):
    rec = ctx["stages"].get("image.uploads")
    if not rec or not ctx["stage_scenes"]:
        return None
    return rec["total"] / ctx["stage_scenes"]
