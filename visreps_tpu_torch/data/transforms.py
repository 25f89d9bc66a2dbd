"""Image resize / crop / normalise on the host, NHWC (copy of
``visreps_tpu/data/transforms.py`` for the eval transform: shorter-side
bilinear resize to 256 → centre crop 224 → optional ImageNet
normalisation, with the PIL-free path for uint8 arrays whose shorter
side is already 256)."""
from __future__ import annotations

from typing import Callable

import numpy as np
from PIL import Image

DS_MEAN = {"imgnet": np.array([0.485, 0.456, 0.406], np.float32)}
DS_STD = {"imgnet": np.array([0.229, 0.224, 0.225], np.float32)}


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def load_image(data_or_path) -> Image.Image:
    """Path / np.ndarray / PIL / array-like → RGB PIL image."""
    if isinstance(data_or_path, str):
        with Image.open(data_or_path) as img:
            return img.convert("RGB")
    if isinstance(data_or_path, Image.Image):
        return data_or_path if data_or_path.mode == "RGB" else data_or_path.convert("RGB")
    arr = np.asarray(data_or_path)
    if arr.ndim == 3:
        return Image.fromarray(arr.astype("uint8"), "RGB")
    raise TypeError(f"Unsupported stimulus type {type(data_or_path)}")


def get_transform(ds_stats: str = "imgnet", image_size: int = 224,
                  normalize: bool = True) -> Callable:
    """Raw stimulus → (H, W, 3) array: float32 normalised, or uint8 when
    ``normalize=False`` (the extractor then normalises on the device)."""
    if ds_stats != "imgnet":
        raise NotImplementedError(f"transform stats {ds_stats!r} are not ported yet")
    resize_size, crop_size = 256, image_size
    mean, std = DS_MEAN[ds_stats], DS_STD[ds_stats]

    def _array_fast(arr: np.ndarray) -> np.ndarray | None:
        # Identity resize (uint8 HWC, shorter side == 256): the transform
        # is a centre-crop slice, bit-exact with the PIL path.
        if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
            return None
        h, w = arr.shape[:2]
        if min(h, w) != resize_size or h < crop_size or w < crop_size:
            return None
        top = int(round((h - crop_size) / 2.0))
        left = int(round((w - crop_size) / 2.0))
        out = arr[top: top + crop_size, left: left + crop_size]
        if not normalize:
            return np.ascontiguousarray(out)
        return (np.asarray(out, np.float32) / 255.0 - mean) / std

    def transform(img) -> np.ndarray:
        if isinstance(img, np.ndarray):
            out = _array_fast(img)
            if out is not None:
                return out
        img = center_crop(resize_shorter(load_image(img), resize_size), crop_size)
        if not normalize:
            return np.asarray(img, np.uint8)
        return (np.asarray(img, np.float32) / 255.0 - mean) / std

    transform.spec = {"resize": resize_size, "crop": crop_size,
                      "mean": tuple(float(m) for m in mean),
                      "std": tuple(float(s) for s in std),
                      "normalize": bool(normalize)}
    return transform
