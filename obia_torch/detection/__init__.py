from obia_tpu_torch.detection import (build_detection_model, calculate_iou,
                                      predict, train_model)
__all__ = ["build_detection_model", "train_model", "predict", "calculate_iou"]
