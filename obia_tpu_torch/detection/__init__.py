"""The detection subsystem (the port's counterpart of
``obia_tpu/detection``): a RetinaNet on ResNet-50 + FPN, built, trained,
evaluated and run on the card unless given ``device="cpu"``."""
from .models import build_detection_model
from .predict import predict
from .train import train_model
from .utils import calculate_iou

__all__ = ["build_detection_model", "train_model", "predict",
           "calculate_iou"]
