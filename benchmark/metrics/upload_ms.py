"""The scene's upload to the card and its cast to float32 (``Image.device_tensor`` on a cache miss): the mean milliseconds a scene spent in the
program's telemetry stage ``image.upload``, over the traced run's scenes with the
telemetry on (each stage then waits for the card at its ends)."""


def read(ctx):
    rec = ctx["stages"].get("image.upload")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
