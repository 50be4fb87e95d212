"""RetinaNet's forward pass (ResNet-50 + FPN + heads, as
``benchmark/reference/retinanet.py`` lays it out): its least time from
the input's padded shape, and its device time in a profiled run.

Least time: the larger of its operations over 67 TFLOP/s (float32, no
TF32) and its bytes over 3.35 TB/s. Operations: 2 Cin Cout k^2 Hout Wout
for every convolution (the elementwise BatchNorm, ReLU, additions and
pooling are left out: under 1% of them). Bytes: the float32 input, every
weight, bias and BatchNorm statistic read once, and the head outputs
written once.

Device time: the card's operations inside the ``detect.forward`` range
that the profiler puts on the device's timeline.
"""
from benchmark.trace import _annotation

from . import FP32_OPS_PER_MS, HBM_BYTES_PER_MS

FORWARD = "detect.forward"
ANCHORS = 9
LEVELS = 5          # P3-P7


def _out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def convs(scene: dict) -> list:
    """Every convolution of the forward over an (H, W) input (the padded
    raster), as (part, cin, cout, k, hout, wout, extras): ``part`` one of
    backbone, fpn and head, ``extras`` the bias or BatchNorm values a
    channel (1 or 4). ``scene`` holds H, W, in_channels, backbone_width,
    stage_sizes, fpn_channels and num_classes."""
    out = []
    part = "backbone"

    def conv(cin, cout, k, stride, extras, hw):
        ho, wo = _out(hw[0], k, stride), _out(hw[1], k, stride)
        out.append((part, cin, cout, k, ho, wo, extras))
        return ho, wo

    width = int(scene["backbone_width"])
    hw = conv(int(scene["in_channels"]), width, 7, 2, 4,
              (int(scene["H"]), int(scene["W"])))
    hw = (_out(hw[0], 3, 2), _out(hw[1], 3, 2))         # the max-pool
    cin, c = width, []
    for i, n in enumerate(scene["stage_sizes"]):
        f = width * 2 ** i
        for j in range(int(n)):
            s = 2 if i > 0 and j == 0 else 1
            conv(cin, f, 1, 1, 4, hw)
            mid = conv(f, f, 3, s, 4, hw)
            conv(f, 4 * f, 1, 1, 4, mid)
            if cin != 4 * f or s != 1:
                conv(cin, 4 * f, 1, s, 4, hw)
            cin, hw = 4 * f, mid
        c.append((cin, hw))
    o = int(scene["fpn_channels"])
    part = "fpn"
    levels = []
    for ch, chw in c[1:]:                               # laterals, outputs
        conv(ch, o, 1, 1, 1, chw)
        levels.append(conv(o, o, 3, 1, 1, chw))
    p6 = conv(c[-1][0], o, 3, 2, 1, c[-1][1])
    levels += [p6, conv(o, o, 3, 2, 1, p6)]
    k = int(scene["num_classes"])
    part = "head"
    for lhw in levels:                                  # the shared heads
        for cout in (ANCHORS * k, ANCHORS * 4):
            for _ in range(4):
                conv(o, o, 3, 1, 1, lhw)
            conv(o, cout, 3, 1, 1, lhw)
    return out


def macs(scene: dict, part=None) -> int:
    """Multiply-adds of every convolution (of ``part`` only, if given)."""
    return sum(ci * co * k * k * ho * wo for p, ci, co, k, ho, wo, _ in
               convs(scene) if part in (None, p))


def anchors(scene: dict) -> int:
    """Anchors of the input: 9 a cell of P3-P7."""
    return sum(ANCHORS * ho * wo for p, ci, co, k, ho, wo, _ in convs(scene)
               if p == "head" and co == ANCHORS * 4)


def params(scene: dict) -> int:
    """Weights, biases and BatchNorm values (the heads' once: the five
    levels share them)."""
    n = {"backbone": 0, "fpn": 0, "head": 0}
    for p, ci, co, k, _, _, e in convs(scene):
        n[p] += ci * co * k * k + e * co
    return n["backbone"] + n["fpn"] + n["head"] // LEVELS


def call_bytes(scene: dict) -> int:
    """Bytes the forward must move: the float32 input, the parameters and
    the (anchors, classes + 4) float32 outputs."""
    outs = anchors(scene) * (int(scene["num_classes"]) + 4)
    return 4 * (int(scene["in_channels"]) * int(scene["H"]) * int(scene["W"])
                + params(scene) + outs)


def bound_ms(scene: dict) -> float:
    """Least time of one forward pass, ms."""
    return max(2 * macs(scene) / FP32_OPS_PER_MS,
               call_bytes(scene) / HBM_BYTES_PER_MS)


def _on_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"


def forward_device_s(events, t0: int, t1: int, name: str = FORWARD):
    """Seconds of the card's operations that start inside the ``name``
    ranges that the profiler puts on the device's timeline, in the
    profiled window [t0, t1] (ns), or None where there are none."""
    ops, ranges = [], []
    for e in events:
        s = int(e.start_ns())
        end = s + int(e.duration_ns())
        if end <= t0 or s >= t1 or not _on_device(e):
            continue
        if _annotation(e):
            if e.name() == name:
                ranges.append((s, end))
        else:
            ops.append((s, end))
    total = sum(e - s for s, e in ops
                if any(a <= s < b for a, b in ranges))
    return total / 1e9 if total > 0 else None
