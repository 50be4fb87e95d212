"""``detection.train.make_train_step`` trains reproducibly: its forward and
backward run under cuDNN's deterministic algorithms (no autotuning), set for
the step only, so two fresh runs of the same steps end on the same model,
as the JAX package's training does.

Bars: on the card (``-m cuda``; run with ``--noconftest``, since
tests/conftest.py imports jax) two fresh runs of 20 steps of the small
model give bitwise equal parameters and losses; on the CPU the step runs
with ``cudnn.deterministic`` on and ``cudnn.benchmark`` off, and leaves
those flags and TF32 as it found them, also when the step raises; and two
CPU runs of 3 steps are bitwise equal.
"""
import numpy as np
import pytest
import torch

from obia_tpu_torch.detection import build_detection_model
from obia_tpu_torch.detection import train as ttrain

S = 128
SMALL = dict(num_classes=2, in_channels=3, backbone_width=8,
             fpn_channels=32, stage_sizes=(1, 1, 1, 1))


def _batch():
    """tests/test_detection.py:243's two scenes: bright 24-px squares on
    noise, CHW float32, with their boxes."""
    imgs, targets = [], []
    for seed, coords in ((0, [(20, 30), (70, 80)]), (1, [(40, 16), (90, 60)])):
        r = np.random.default_rng(seed)
        img = r.normal(0.0, 0.05, (S, S, 3)).astype(np.float32)
        for x0, y0 in coords:
            img[y0:y0 + 24, x0:x0 + 24] += 1.0
        imgs.append(np.transpose(img, (2, 0, 1)))
        targets.append({"boxes": np.array([[x0, y0, x0 + 24, y0 + 24]
                                           for x0, y0 in coords],
                                          np.float32),
                        "labels": np.array([1, 1], np.int64)})
    return imgs, targets


def _train(device, steps):
    """(losses, parameters on the host) of a fresh model after ``steps``
    Adam steps (lr 2e-3) on the two scenes."""
    model = build_detection_model(seed=0, image_size=(S, S), device=device,
                                  **SMALL)
    step = ttrain.make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=2e-3))
    imgs, targets = _batch()
    losses = [float(step(imgs, targets)) for _ in range(steps)]
    return losses, {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}


def _assert_same(a, b):
    assert a[0] == b[0]
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.mark.cuda
def test_two_card_runs_are_bitwise_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    first = _train("cuda", 20)
    second = _train("cuda", 20)
    assert all(np.isfinite(first[0])) and first[0][-1] < first[0][0]
    _assert_same(first, second)


def test_two_cpu_runs_are_bitwise_equal():
    first = _train("cpu", 3)
    _assert_same(first, _train("cpu", 3))


@pytest.mark.parametrize("deterministic,benchmark", [(False, True),
                                                     (True, False),
                                                     (False, False)])
def test_step_sets_the_flags_for_itself_only(monkeypatch, deterministic,
                                             benchmark):
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", deterministic)
    monkeypatch.setattr(cudnn, "benchmark", benchmark)
    tf32 = cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    seen = []
    real = ttrain.batch_loss

    def spy(*a, **k):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return real(*a, **k)

    monkeypatch.setattr(ttrain, "batch_loss", spy)
    model = build_detection_model(seed=0, image_size=(S, S), device="cpu",
                                  **SMALL)
    step = ttrain.make_train_step(model, torch.optim.SGD(
        model.parameters(), lr=1e-3))
    step(*_batch())
    assert seen == [(True, False)]
    assert (cudnn.deterministic, cudnn.benchmark) == (deterministic,
                                                      benchmark)
    assert (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == tf32

    def boom(*a, **k):
        raise RuntimeError("forward failed")

    monkeypatch.setattr(ttrain, "batch_loss", boom)
    with pytest.raises(RuntimeError, match="forward failed"):
        step(*_batch())
    assert (cudnn.deterministic, cudnn.benchmark) == (deterministic,
                                                      benchmark)
