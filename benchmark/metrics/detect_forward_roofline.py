"""RetinaNet's forward pass against its roofline: the least time of the
profiled scenes' forward passes (``roofline/retinanet.py``, from the
padded input's shape) over the device time of the card's operations in
their ``detect.forward`` ranges."""
from benchmark.roofline import retinanet


def read(ctx):
    spent = ctx.get("forward_s")
    scenes = ctx.get("traced_scenes")
    if not spent or not scenes:
        return None
    return 100.0 * sum(retinanet.bound_ms(s) for s in scenes) / \
        (1000.0 * spent)
