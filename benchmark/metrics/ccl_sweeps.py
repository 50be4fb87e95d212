"""Connected components' host-synced propagation sweeps (``ccl_roots``: one a pass, each ending in a sync): the mean a scene of the program's
telemetry counter ``ccl.sweeps``, over the traced run's scenes with the
telemetry on."""


def read(ctx):
    rec = ctx["stages"].get("ccl.sweeps")
    if not rec or not ctx["stage_scenes"]:
        return None
    return rec["total"] / ctx["stage_scenes"]
