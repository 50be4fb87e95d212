"""The plain reference of the detector's cell: RetinaNet on ResNet-50 + FPN
(Lin et al., arXiv:1708.02002; He et al., arXiv:1512.03385; Lin et al.,
arXiv:1612.03144) as iosefa/obia's ``detection`` builds and runs it,
written in plain torch and numpy from the published description. It
imports nothing of the program.

The forward pass takes the weights as data, a dict of tensors named as the
program's ``state_dict()`` names them, and runs float32 with TF32 off (the
module switches TF32 off around every forward itself). The weights are
drawn here (:func:`init_weights`) and calibrated here (:func:`calibrate`)
with this module's own forward pass; the program's model is handed them.
Its layout:

- a 7x7/2 stem (padding 3, no bias), BatchNorm, ReLU, a 3x3/2 max-pool
  (padding 1);
- bottleneck blocks (1x1, 3x3, 1x1 at 4x expansion) in stages of
  ``stage_sizes``, base width ``w``; the first block of every stage
  projects its shortcut (1x1 convolution and BatchNorm). Departure from
  the paper's v1: a stage's stride 2 sits on the 3x3 convolution and the
  projection (torchvision's "v1.5"), as in the program and obia;
- C3, C4, C5 from the last three stages; FPN laterals (1x1) and outputs
  (3x3) with biases, the top-down path a nearest 2x upsample cropped to
  the finer map; P6 a 3x3/2 convolution of C5 and P7 one of relu(P6), as
  the RetinaNet paper has it (torchvision's ``retinanet_resnet50_fpn``
  takes P6 from P5: a departure the program shares);
- heads shared over P3-P7, four 3x3 convolutions with ReLU each for the
  class and the box branch, then 3x3 outputs of A*K and A*4 channels,
  A = 9 anchors a cell; outputs flattened in (level, y, x, anchor) order;
- BatchNorm in evaluation form, ``(x - mean) / sqrt(var + 1e-5) * w + b``.

No normalisation is applied to the input: obia's ``predict`` scales the
raster to uint8 by its global minimum and maximum (:func:`scale_to_uint8`)
and feeds those values; the input is zero-padded to a multiple of 128.

Decoding, filtering and NMS follow obia's ``predict`` with torchvision's
RetinaNet conventions: anchors of sizes 32-512 at strides 8-128, scales
2^0, 2^(1/3), 2^(2/3) and ratios 0.5, 1, 2; boxes decoded from (dx, dy,
dw, dh) normalised by the anchor's size, with dw and dh clamped to [-10,
6] (the program's bound; torchvision clamps above at log(1000/16) only);
sigmoid scores, the best class past slot 0 (background), the score
filter; greedy NMS per class in the order ``np.argsort(-scores)`` gives,
each kept box suppressing every remaining candidate of its class with IoU
above the threshold (computed in float64, against every candidate), at
most ``max_out`` kept; boxes clipped to the unpadded raster last.

:func:`judge` gives the numbers that decide ``correct``; :func:`control`
is this reference in a lower precision put in the program's place.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

LEVEL_STRIDES = (8, 16, 32, 64, 128)
LEVEL_SIZES = (32, 64, 128, 256, 512)
SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
RATIOS = (0.5, 1.0, 2.0)
PAD = 128
BN_EPS = 1e-5
DELTA_CLAMP = (-10.0, 6.0)

#: the class output's bias, the focal loss paper's prior of 0.01
FOCAL_PRIOR = -math.log((1 - 0.01) / 0.01)
#: a standard normal truncated to [-2, 2] has this standard deviation
TRUNCATED_STD = 0.87962566103423978

#: the numbers :func:`judge` returns
NUMBERS = ("logit_gap", "delta_gap", "kept_mismatch", "score_gap",
           "box_gap")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matmuls and cuDNN convolutions ``on`` or off
    inside the block, restored after it."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = was


# -- the input ---------------------------------------------------------------

def scale_to_uint8(arr: np.ndarray) -> np.ndarray:
    """obia's global scaling: ``255 (x - min) / (max - min + 1e-8)`` in
    float64, clipped to 0..255 and truncated to uint8 (a constant raster is
    only clipped)."""
    lo, hi = float(arr.min()), float(arr.max())
    x = arr.astype(np.float64)
    if hi > lo:
        x = 255.0 * (x - lo) / (hi - lo + 1e-8)
    return np.clip(x, 0, 255).astype(np.uint8)


def padded_input(u8: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """The (H, W, C) raster as a (1, C, H', W') tensor, zero-padded at the
    bottom and right to multiples of 128."""
    H, W, C = u8.shape
    ph, pw = -(-H // PAD) * PAD, -(-W // PAD) * PAD
    x = torch.zeros((1, C, ph, pw), dtype=dtype, device=device)
    x[0, :, :H, :W] = torch.as_tensor(u8, device=device).permute(
        2, 0, 1).to(dtype)
    return x


# -- the weights ---------------------------------------------------------------

def shapes(model: dict) -> dict:
    """Every weight's shape by module name, in drawing order, for the
    architecture ``model`` (``in_channels``, ``backbone_width``,
    ``stage_sizes``, ``fpn_channels``, ``num_classes``)."""
    out = {}

    def conv(name, cout, cin, k, bias=True):
        out[name + ".weight"] = (cout, cin, k, k)
        if bias:
            out[name + ".bias"] = (cout,)

    def bn(name, ch):
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{p}"] = (ch,)

    w = int(model["backbone_width"])
    conv("ResNet50_0.conv1", w, int(model["in_channels"]), 7, False)
    bn("ResNet50_0.BatchNorm_0", w)
    cin, k, c = w, 0, []
    for i, n in enumerate(model["stage_sizes"]):
        f = w * 2 ** i
        for j in range(n):
            b = f"ResNet50_0.Bottleneck_{k}"
            for m, (cout, ci, ks) in enumerate(((f, cin, 1), (f, f, 3),
                                                (4 * f, f, 1))):
                conv(f"{b}.Conv_{m}", cout, ci, ks, False)
                bn(f"{b}.BatchNorm_{m}", cout)
            if j == 0:
                conv(b + ".Conv_3", 4 * f, cin, 1, False)
                bn(b + ".BatchNorm_3", 4 * f)
            cin, k = 4 * f, k + 1
        c.append(cin)
    o = int(model["fpn_channels"])
    for lvl, ch in zip((5, 4, 3), c[:0:-1]):
        conv(f"FPN_0.lat{lvl}", o, ch, 1)
    for lvl in (3, 4, 5):
        conv(f"FPN_0.out{lvl}", o, o, 3)
    conv("FPN_0.p6", o, c[-1], 3)
    conv("FPN_0.p7", o, o, 3)
    a = len(SCALES) * len(RATIOS)
    for branch in ("cls", "box"):
        for i in range(4):
            conv(f"RetinaNetHead_0.{branch}_t{i}", o, o, 3)
    for branch, k_out in (("cls", int(model["num_classes"])), ("box", 4)):
        conv(f"RetinaNetHead_0.{branch}_out", a * k_out, o, 3)
    return out


def init_weights(model: dict, generator: torch.Generator) -> dict:
    """Float32 weights of the architecture ``model`` on the host, drawn
    from ``generator`` in :func:`shapes`' order: convolution kernels LeCun
    normal (a standard normal truncated to [-2, 2], over its standard
    deviation, times 1/sqrt(fan-in)), biases 0 but the class output's,
    the focal prior; BatchNorm scale 1, shift 0, running mean 0 and
    variance 1."""
    lo, hi = (0.5 * math.erfc(v / math.sqrt(2)) for v in (2.0, -2.0))
    out = {}
    for name, shape in shapes(model).items():
        if len(shape) == 4:
            u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                            dtype=torch.float64)
            fan_in = shape[1] * shape[2] * shape[3]
            t = torch.special.ndtri(u) / (TRUNCATED_STD * math.sqrt(fan_in))
        elif name.endswith(("running_var", "weight")):
            t = torch.ones(shape)
        elif name == "RetinaNetHead_0.cls_out.bias":
            t = torch.full(shape, FOCAL_PRIOR)
        else:
            t = torch.zeros(shape)
        out[name] = t.float()
    return out


@torch.no_grad()
def calibrate(weights: dict, x: torch.Tensor, model: dict,
              calibration: dict) -> float:
    """Stand in for a trained model's statistics on one calibration input
    ``x`` (:func:`padded_input`): ``weights``, on ``x``'s device, change in
    place, and the score threshold is returned.

    - every BatchNorm's running statistics become the mean and the biased
      variance of its input in one forward pass that normalises by them
      (a train-mode pass; as initialised, mean 0 and variance 1 on the raw
      0-255 input, most scores saturate at 1.0);
    - the box output's weights and bias are scaled, one factor for each of
      dx, dy, dw and dh over all anchors, so that the input's box deltas
      spread as ``calibration["box_delta_std"]`` (as drawn they spread
      0.5-0.9, and exp(dw) makes boxes up to ~150 times their anchors);
    - the threshold is the score that the best
      ``calibration["candidate_share"]`` of the anchors reach (their best
      class past the background's slot)."""
    forward(weights, x, model["stage_sizes"], model["num_classes"],
            batch_stats=True)
    logits, deltas = forward(weights, x, model["stage_sizes"],
                             model["num_classes"])
    want = torch.tensor(calibration["box_delta_std"], device=deltas.device)
    name = "RetinaNetHead_0.box_out"
    factor = (want / deltas.std(dim=0)).repeat(
        weights[name + ".bias"].numel() // 4)
    weights[name + ".weight"] = weights[name + ".weight"] * \
        factor[:, None, None, None]
    weights[name + ".bias"] = weights[name + ".bias"] * factor
    scores = torch.sigmoid(logits[:, 1:] if logits.shape[1] > 1
                           else logits).amax(dim=1)
    k = max(1, round(float(calibration["candidate_share"]) * scores.numel()))
    return float(torch.topk(scores, k).values[-1])


# -- the forward pass --------------------------------------------------------

class _Weights:
    """The weights by module name, cast to the forward's dtype; with
    ``batch_stats`` every BatchNorm first sets its running statistics to
    those of its input."""

    def __init__(self, weights: dict, dtype, device, batch_stats=False):
        self.w = weights
        self.dtype = dtype
        self.device = device
        self.batch_stats = batch_stats

    def __call__(self, name: str):
        t = self.w.get(name)
        return None if t is None else t.to(self.device, self.dtype)


def _bn(x, W, name):
    if W.batch_stats:
        mean = x.mean(dim=(0, 2, 3))
        W.w[name + ".running_mean"] = mean
        W.w[name + ".running_var"] = \
            (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    mean, var = W(name + ".running_mean"), W(name + ".running_var")
    scale = W(name + ".weight") / torch.sqrt(var + BN_EPS)
    return (x - mean[:, None, None]) * scale[:, None, None] + \
        W(name + ".bias")[:, None, None]


def _conv(x, W, name, stride=1):
    w = W(name + ".weight")
    return F.conv2d(x, w, W(name + ".bias"), stride=stride,
                    padding=w.shape[-1] // 2)


def _bottleneck(x, W, name, stride):
    y = F.relu(_bn(_conv(x, W, name + ".Conv_0"), W, name + ".BatchNorm_0"))
    y = F.relu(_bn(_conv(y, W, name + ".Conv_1", stride), W,
                   name + ".BatchNorm_1"))
    y = _bn(_conv(y, W, name + ".Conv_2"), W, name + ".BatchNorm_2")
    if W(name + ".Conv_3.weight") is not None:
        x = _bn(_conv(x, W, name + ".Conv_3", stride), W,
                name + ".BatchNorm_3")
    return F.relu(y + x)


def _up(x, like):
    return F.interpolate(x, scale_factor=2, mode="nearest")[
        :, :, :like.shape[2], :like.shape[3]]


def _head(feats, W, branch, k):
    outs = []
    for f in feats:
        for i in range(4):
            f = F.relu(_conv(f, W, f"RetinaNetHead_0.{branch}_t{i}"))
        f = _conv(f, W, f"RetinaNetHead_0.{branch}_out")
        outs.append(f[0].permute(1, 2, 0).reshape(-1, k))
    return torch.cat(outs)


def forward(weights: dict, x: torch.Tensor, stage_sizes, num_classes: int,
            dtype=torch.float32, allow_tf32: bool = False,
            batch_stats: bool = False):
    """(class logits (N, K), box deltas (N, 4)) in float32 of the padded
    input ``x`` (1, C, H', W'), computed in ``dtype`` (TF32 ``allow_tf32``)
    on ``x``'s device; ``batch_stats`` (float32 only) sets every
    BatchNorm's running statistics in ``weights`` to its input's first."""
    W = _Weights(weights, dtype, x.device, batch_stats)
    with tf32(allow_tf32), torch.no_grad():
        y = x.to(dtype)
        y = F.relu(_bn(_conv(y, W, "ResNet50_0.conv1", 2), W,
                       "ResNet50_0.BatchNorm_0"))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        c, k = [], 0
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                y = _bottleneck(y, W, f"ResNet50_0.Bottleneck_{k}",
                                2 if i > 0 and j == 0 else 1)
                k += 1
            c.append(y)
        c3, c4, c5 = c[1:]
        p5 = _conv(c5, W, "FPN_0.lat5")
        p4 = _conv(c4, W, "FPN_0.lat4") + _up(p5, c4)
        p3 = _conv(c3, W, "FPN_0.lat3") + _up(p4, c3)
        p6 = _conv(c5, W, "FPN_0.p6", 2)
        p7 = _conv(F.relu(p6), W, "FPN_0.p7", 2)
        feats = (_conv(p3, W, "FPN_0.out3"), _conv(p4, W, "FPN_0.out4"),
                 _conv(p5, W, "FPN_0.out5"), p6, p7)
        logits = _head(feats, W, "cls", num_classes)
        deltas = _head(feats, W, "box", 4)
    return logits.float(), deltas.float()


# -- decode, filter, NMS --------------------------------------------------

def anchors(ph: int, pw: int) -> np.ndarray:
    """(N, 4) float32 xyxy anchors of a padded (ph, pw) input, by level,
    then cell (row-major), then (scale, ratio); worked in float64."""
    out = []
    for stride, size in zip(LEVEL_STRIDES, LEVEL_SIZES):
        ys = (np.arange(-(-ph // stride)) + 0.5) * stride
        xs = (np.arange(-(-pw // stride)) + 0.5) * stride
        wh = np.array([(size * s * math.sqrt(1.0 / r),
                        size * s * math.sqrt(r))
                       for s in SCALES for r in RATIOS])
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        c = np.stack([cx, cy], -1).reshape(-1, 1, 2)
        out.append(np.concatenate([c - wh / 2, c + wh / 2], -1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def decode(anchor_xyxy: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Boxes (N, 4) xyxy from deltas (dx, dy, dw, dh) on the anchors."""
    aw = anchor_xyxy[:, 2] - anchor_xyxy[:, 0]
    ah = anchor_xyxy[:, 3] - anchor_xyxy[:, 1]
    ax = anchor_xyxy[:, 0] + aw / 2
    ay = anchor_xyxy[:, 1] + ah / 2
    cx = deltas[:, 0] * aw + ax
    cy = deltas[:, 1] * ah + ay
    w = torch.exp(torch.clamp(deltas[:, 2], *DELTA_CLAMP)) * aw
    h = torch.exp(torch.clamp(deltas[:, 3], *DELTA_CLAMP)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)


def candidates(logits: torch.Tensor, deltas: torch.Tensor, padded_hw,
               score_threshold: float, dtype=torch.float32) -> dict:
    """Decode and filter on the head outputs' device, in ``dtype``: the
    candidates' anchor ids, boxes, scores and labels on the host (boxes
    and scores in float32)."""
    dev = logits.device
    a = torch.as_tensor(anchors(*padded_hw), device=dev).to(dtype)
    boxes = decode(a, deltas.to(dtype))
    probs = torch.sigmoid(logits.to(dtype))
    first = 1 if probs.shape[1] > 1 else 0
    scores, labels = probs[:, first:].max(dim=1)
    keep = scores >= score_threshold
    return {"ids": torch.nonzero(keep)[:, 0].cpu().numpy(),
            "boxes": boxes[keep].float().cpu().numpy(),
            "scores": scores[keep].float().cpu().numpy(),
            "labels": (labels[keep] + first).cpu().numpy()}


def iou_one(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box with each of ``boxes``, float64."""
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = (np.clip(box[2] - box[0], 0, None)
            * np.clip(box[3] - box[1], 0, None))
    areas = (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
             * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))
    return inter / np.maximum(area + areas - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
        iou_threshold: float, max_out: int) -> np.ndarray:
    """Indices kept by greedy per-class NMS, in the order kept."""
    b = boxes.astype(np.float64)
    alive = np.ones(len(b), bool)
    keep = []
    for i in np.argsort(-scores):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) == max_out:
            break
        alive[i] = False
        rest = np.flatnonzero(alive & (labels == labels[i]))
        alive[rest[iou_one(b[i], b[rest]) > iou_threshold]] = False
    return np.asarray(keep, np.int64)


def detect(logits: torch.Tensor, deltas: torch.Tensor, hw, predict: dict,
           dtype=torch.float32) -> dict:
    """The reference's detections from head outputs of an (H, W) raster:
    every candidate (:func:`candidates`, its box clipped to the raster)
    and ``keep``, the indices of those NMS keeps, in the order kept."""
    H, W = hw
    padded = (-(-H // PAD) * PAD, -(-W // PAD) * PAD)
    cand = candidates(logits, deltas, padded,
                      float(predict["score_threshold"]), dtype)
    cand["keep"] = nms(cand["boxes"], cand["scores"], cand["labels"],
                       float(predict["nms_threshold"]),
                       int(predict["max_out"]))
    cand["boxes"][:, 0::2] = np.clip(cand["boxes"][:, 0::2], 0, W)
    cand["boxes"][:, 1::2] = np.clip(cand["boxes"][:, 1::2], 0, H)
    return cand


def kept(det: dict) -> dict:
    """The detections :func:`detect` keeps, as the program returns them."""
    k = det["keep"]
    return {"boxes": det["boxes"][k], "scores": det["scores"][k],
            "labels": det["labels"][k]}


# -- the comparison -------------------------------------------------------

def gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Widest abs(program - reference) over max(abs(reference), the mean
    abs(reference) of the whole output)."""
    r = reference.double()
    diff = (program.to(r.device).double() - r).abs()
    scale = torch.clamp(r.abs(), min=float(r.abs().mean()))
    rel = torch.where(scale > 0, diff / torch.where(scale > 0, scale, 1.0),
                      torch.where(diff > 0, math.inf, 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def kept_numbers(program: dict, det: dict) -> dict:
    """``kept_mismatch``, ``score_gap`` and ``box_gap`` of the program's
    kept detections against the reference's of the same head outputs.
    Each program detection is matched to the candidate of its label with
    the nearest box (the largest coordinate gap, then the score gap; of
    candidates that read the same, one the reference kept); the
    mismatch counts the matched candidates NMS did not keep, the kept ones
    left unmatched, and candidates matched twice. The gaps are the widest
    over the matches (pixels; score)."""
    cb = det["boxes"].astype(np.float64)
    cs = det["scores"].astype(np.float64)
    ref = set(det["keep"].tolist())
    matched, box_gap, score_gap = [], 0.0, 0.0
    for box, score, label in zip(program["boxes"], program["scores"],
                                 program["labels"]):
        d = np.abs(cb - np.asarray(box, np.float64)).max(axis=1)
        d[det["labels"] != label] = math.inf
        if not len(d) or not np.isfinite(d.min()):
            matched.append(-1)
            box_gap = math.inf
            continue
        near = np.flatnonzero(d == d.min())
        ds = np.abs(cs[near] - float(score))
        near = near[ds == ds.min()].tolist()
        # candidates that read the same are the same output: prefer one
        # the reference kept and nothing matched yet
        i = next((j for j in near if j in ref and j not in matched),
                 next((j for j in near if j not in matched), near[0]))
        matched.append(i)
        box_gap = max(box_gap, float(d[i]))
        score_gap = max(score_gap, abs(float(cs[i]) - float(score)))
    got = set(matched)
    mismatch = len(got ^ ref) + len(matched) - len(got)
    return {"kept_mismatch": mismatch, "score_gap": score_gap,
            "box_gap": box_gap}


def judge(program: dict, heads, scene: np.ndarray, weights: dict,
          model: dict, predict: dict) -> dict:
    """The numbers of one scene: ``program`` the kept detections (boxes,
    scores, labels) and ``heads`` the (logits (N, K), deltas (N, 4)) its
    timed path produced from ``scene``, the raw (H, W, C) raster, with the
    architecture ``model`` (``stage_sizes``, ``num_classes``) and the
    ``predict`` settings (``score_threshold``, ``nms_threshold``,
    ``max_out``); the reference's forward runs on the heads' device."""
    logits, deltas = heads
    m = model
    x = padded_input(scale_to_uint8(scene), logits.device)
    ref_logits, ref_deltas = forward(weights, x, m["stage_sizes"],
                                     m["num_classes"])
    del x
    nums = {"logit_gap": gap(logits, ref_logits),
            "delta_gap": gap(deltas, ref_deltas)}
    del ref_logits, ref_deltas
    det = detect(logits, deltas, scene.shape[:2], predict)
    nums.update(kept_numbers(program, det))
    return nums


#: lower precisions than the configuration's float32, as controls
CONTROLS = {"tf32": {"dtype": torch.float32, "allow_tf32": True},
            "bfloat16": {"dtype": torch.bfloat16, "allow_tf32": False}}


def control(scene: np.ndarray, weights: dict, model: dict, predict: dict,
            device, name: str):
    """This reference in the lower precision ``name`` of :data:`CONTROLS`
    put in the program's place: its kept detections and head outputs of
    ``scene``, in :func:`judge`'s form (the bfloat16 control decodes in
    bfloat16 too; TF32 touches only the convolutions)."""
    p = CONTROLS[name]
    x = padded_input(scale_to_uint8(scene), device)
    heads = forward(weights, x, model["stage_sizes"], model["num_classes"],
                    p["dtype"], p["allow_tf32"])
    det = detect(*heads, scene.shape[:2], predict, p["dtype"])
    return kept(det), heads
