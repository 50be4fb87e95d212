"""The quickshift parent scan's share of its roofline: the least time of
the profiled scenes' scans (``roofline/quickshift.py``, from the
problem's shapes) over the device time of its kernel."""
from benchmark.roofline import quickshift


def read(ctx):
    tr = ctx["trace"]
    scenes = [s for s in ctx["traced_scenes"] if s.get("qs")]
    if tr is None or tr.empty or not scenes:
        return None
    spent = tr.kernel_s(quickshift.PARENT_KERNELS)
    if spent <= 0:
        return None
    bound = sum(quickshift.parent_bound_ms(
        s["qs"]["C"], s["H"], s["W"], s["qs"]["radius"], s["qs"]["max_dist"])
        for s in scenes)
    return 100.0 * bound / (1000.0 * spent)
