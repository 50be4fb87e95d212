"""Tree-detection dataset (the port's counterpart of
``obia_tpu/detection/dataset.py``).

``TreeDetectionDataset`` (reference dataset.py:9-77): JSON annotations
keyed by image id with ``file_name``/``boxes``/``labels``, per-image min-max
scaling to uint8 (:52-57), an augmentation hook with the albumentations
calling convention (image=/bboxes=/labels= -> dict, :62-69), and band-first
float32 numpy output with a ``{"boxes", "labels"}`` target. GeoTIFFs are
read with the port's own codec; other image files with PIL, imported only
for them. ``DataLoader`` shuffles with numpy's ``default_rng(seed)``, so a
seed gives the JAX package's batches.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch.utils.data

from ..io.tiff import TiffReader


class TreeDetectionDataset(torch.utils.data.Dataset):
    def __init__(self, images_dir: str, annotations_path: str,
                 transforms: Optional[Callable] = None,
                 do_scale: bool = True):
        self.images_dir = images_dir
        self.transforms = transforms
        self.do_scale = do_scale
        with open(annotations_path, "r") as f:
            self.annotations = json.load(f)
        self.image_ids = list(self.annotations.keys())

    def __len__(self) -> int:
        return len(self.image_ids)

    def __getitem__(self, idx: int):
        image_id = self.image_ids[idx]
        ann = self.annotations[image_id]
        image_path = os.path.join(self.images_dir, ann["file_name"])

        if image_path.lower().endswith((".tif", ".tiff")):
            image_array = TiffReader(image_path).read()
        else:
            from PIL import Image as PILImage
            image_array = np.asarray(PILImage.open(image_path))
            if image_array.ndim == 2:
                image_array = image_array[:, :, None]

        if self.do_scale:
            # the reference's arithmetic as written, so numpy's dtype
            # promotion (and its rounding) stays the same
            data_min = image_array.min()
            data_max = image_array.max()
            if data_max > data_min:
                image_array = 255.0 * (image_array - data_min) / \
                    (data_max - data_min + 1e-8)
            image_array = np.clip(image_array, 0, 255).astype(np.uint8)

        boxes = ann["boxes"]
        labels = ann["labels"]

        if self.transforms is not None:
            augmented = self.transforms(image=image_array, bboxes=boxes,
                                        labels=labels)
            image_array = augmented["image"]
            boxes = augmented["bboxes"]
            labels = augmented["labels"]

        image = np.asarray(image_array, np.float32).transpose(2, 0, 1)  # CHW
        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64).reshape(-1),
        }
        return image, target


class DataLoader:
    """Minimal detection data loader (numpy-seeded shuffling + collate),
    standing in for ``torch.utils.data.DataLoader`` in the reference flow:
    each epoch draws its order from one ``default_rng(seed)``, as the JAX
    package's loader does."""

    def __init__(self, dataset, batch_size: int = 2, shuffle: bool = True,
                 collate_fn: Optional[Callable] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda b: tuple(zip(*b)))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            batch = [self.dataset[int(i)] for i in order[s:s + self.batch_size]]
            yield self.collate_fn(batch)
