"""Image-folder dataset (pre-cut patch folders), ``tpuwsi/io/folder.py``.

The same class maps, splits, sample order and batch bytes as the reference.
Images are decoded by ``io.image.load_image``: ``.png`` without PIL, other
extensions through PIL where it is installed. Batches are raw uint8 NHWC;
augmentation happens on the device.

The port's one addition: ``batches(..., workers=N)`` reads and decodes each
batch's PNG files on N threads of ``io.image.load_images``, outside the
interpreter lock, in the same order.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpuwsi_torch.io.image import load_image, load_images

IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".webp")

VAL_DIR_NAMES = ("val", "validation", "valid")


def load_class_map(path: str) -> Dict[str, int]:
    """timm --class-map: one class name per line; the index is the line number."""
    with open(path) as f:
        names = [line.strip() for line in f if line.strip()]
    return {name: i for i, name in enumerate(names)}


def load_folder_datasets(
    root: str,
    image_size: Optional[int] = None,
    train_split: str = "train",
    class_map: Optional[str] = None,
    channels: int = 3,
):
    """(train_ds, val_ds) for a folder tree: ``<train_split>/`` and a
    ``val``/``validation``/``valid`` subtree when the root has them (the val
    split takes the train split's class map unless ``class_map`` is given),
    else the whole root and None."""
    cmap = load_class_map(class_map) if class_map else None
    subdirs = {d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))}
    if train_split in subdirs:
        val_name = next((v for v in VAL_DIR_NAMES if v in subdirs), None)
        train_ds = ImageFolderDataset(os.path.join(root, train_split), image_size=image_size,
                                      class_map=cmap, channels=channels)
        val_ds = (
            ImageFolderDataset(os.path.join(root, val_name), image_size=image_size,
                               class_map=cmap or train_ds.class_to_idx, channels=channels)
            if val_name else None)
        return train_ds, val_ds
    return ImageFolderDataset(root, image_size=image_size, class_map=cmap,
                              channels=channels), None


class ImageFolderDataset:
    def __init__(self, root: str, image_size: Optional[int] = None,
                 class_map: Optional[Dict[str, int]] = None, channels: int = 3):
        if channels not in (1, 3):
            raise ValueError("channels must be 1 or 3")
        self.channels = channels
        self.root = root
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise IOError(f"no class subdirectories under {root}")
        if class_map is not None:
            missing = [c for c in classes if c not in class_map]
            if missing:
                raise KeyError(f"class dirs {missing} not in the --class-map file")
            self.class_to_idx = {c: class_map[c] for c in classes}
            # the index space is the whole map, not the dirs of this split
            self._num_classes = max(class_map.values()) + 1
        else:
            self.class_to_idx = {c: i for i, c in enumerate(classes)}
            self._num_classes = len(classes)
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))
        self.image_size = image_size

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def subset(self, indices) -> "ImageFolderDataset":
        """Shallow view over a sample subset (same class map)."""
        ds = copy.copy(self)
        ds.samples = [self.samples[int(i)] for i in indices]
        return ds

    def split(self, fraction: float = 0.8, rng=None):
        """Random train/val split (timm --val-split analogue)."""
        rng = rng or np.random.default_rng(0)
        order = rng.permutation(len(self.samples))
        n_train = int(round(len(order) * fraction))
        return self.subset(order[:n_train]), self.subset(order[n_train:])

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int) -> np.ndarray:
        path, _ = self.samples[idx]
        return load_image(path, self.channels, self.image_size)

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        repeats: int = 1,
        workers: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``{"images": uint8 (B, H, W, C), "labels": int64 (B,)}``
        in the reference's order, each batch's files decoded on ``workers``
        threads (one where ``workers`` is 0)."""
        order = np.arange(len(self.samples))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        if repeats > 1:
            # timm --aug-repeats: adjacent repeats, truncated to the epoch length
            order = np.repeat(order, repeats)[: len(self.samples)]
        # one length on every host: a strided slice, cut to the common length
        order = order[process_index::process_count][: len(order) // process_count]
        end = len(order) - (batch_size - 1 if drop_last else 0)
        for start in range(0, max(end, 0), batch_size):
            chunk = [int(i) for i in order[start:start + batch_size]]
            images = load_images([self.samples[i][0] for i in chunk], self.channels,
                                 self.image_size, threads=max(workers, 1))
            labels = np.asarray([self.samples[i][1] for i in chunk], dtype=np.int64)
            yield {"images": images, "labels": labels}
