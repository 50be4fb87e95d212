"""Launches of SLIC's k-means pass kernel (``csrc/slic.cu``; one a pass,
``max_num_iter + 1`` a SLIC call): the mean a scene of the program's
telemetry counter ``kernel.slic_pass``, over the traced run's scenes with
the telemetry on. A program without the kernel has no such counter, and
the metric reads nothing."""


def read(ctx):
    rec = ctx["stages"].get("kernel.slic_pass")
    if not rec or not ctx["stage_scenes"]:
        return None
    return rec["total"] / ctx["stage_scenes"]
