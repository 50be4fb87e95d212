"""The host's float32 copy of each scene as it enters (``image_from_array``, ``as_image``, ``open_geotiff``): the mean milliseconds a scene spent in the
program's telemetry stage ``image.convert``, over the traced run's scenes with the
telemetry on (host clock: it never waits for the card)."""


def read(ctx):
    rec = ctx["stages"].get("image.convert")
    if not rec or not ctx["stage_scenes"]:
        return None
    return 1000.0 * rec["total_s"] / ctx["stage_scenes"]
