"""The small-segment merge's host-synced adoption sweeps (``_sweep`` in ``_merge_lut_loop``): the mean a scene of the program's
telemetry counter ``merge.sweeps``, over the traced run's scenes with the
telemetry on."""


def read(ctx):
    rec = ctx["stages"].get("merge.sweeps")
    if not rec or not ctx["stage_scenes"]:
        return None
    return rec["total"] / ctx["stage_scenes"]
