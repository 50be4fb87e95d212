"""``glcm_sums``' share of its roofline: the least time of every call the
profiled scenes made (``roofline/glcm_sums.py``, from the problem's
shapes) over the device time of the kernels a call launches."""
from benchmark.roofline import glcm_sums


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.empty:
        return None
    spent = tr.kernel_s(glcm_sums.KERNELS)
    if spent <= 0:
        return None
    bound = sum(glcm_sums.bound_ms(s) for s in ctx["traced_scenes"])
    return 100.0 * bound / (1000.0 * spent)
