"""Page-image preprocessing — the half of the reference's HF image
processors the pipeline uses (resize + normalize). The port's copy of
``peneo_tpu/data/image_processing.py``; the host half is numpy/PIL, the
device half (:func:`device_image_normalize`) torch.

- LayoutLMv3ImageProcessor: resize to 224×224 (bilinear), rescale 1/255,
  normalize mean=std=0.5, CHW float32.
- LayoutLMv2ImageProcessor: resize to 224×224, RGB→BGR flip, raw 0-255
  float32 CHW (the model normalizes by the detectron2 pixel mean and std
  before its visual tower).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def resized_rgb(path: str, size: int):
    """The page at ``path`` as a (size, size) RGB PIL image: bilinear
    resize, then RGB. The file is read in one call and decoded in one call,
    and a grayscale page is resized before its channels are made, which
    gives the same pixels (PIL resizes each 8-bit channel alike) at a third
    of the resize. Each call into PIL gives the interpreter lock away and
    takes it back, and in the serving pools each take can wait out another
    thread's switch interval: PIL's own reader decodes in 64-KB blocks, a
    round of the lock each."""
    import io

    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    with Image.open(io.BytesIO(data)) as im:
        im.decodermaxblock = max(im.decodermaxblock, len(data))
        if im.mode == "L":
            return im.resize((size, size), Image.BILINEAR).convert("RGB")
        return im.convert("RGB").resize((size, size), Image.BILINEAR)


def load_rgb(path: str, size: int) -> np.ndarray:
    # (H, W, 3) in [0, 255]
    return np.asarray(resized_rgb(path, size), dtype=np.float32)


def layoutlmv3_preprocess(path: str, size: int = 224) -> np.ndarray:
    arr = load_rgb(path, size) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)  # CHW


def layoutlmv2_preprocess(path: str, size: int = 224) -> np.ndarray:
    arr = load_rgb(path, size)
    return arr[..., ::-1].transpose(2, 0, 1).copy()  # BGR, CHW, 0-255


def load_rgb_u8(path: str, size: int) -> np.ndarray:
    """Decode + resize only — uint8 (H, W, 3) RGB. The serving path: the
    normalization and the transpose run on the device
    (:func:`device_image_normalize`), so the host does no float conversion
    and the upload is a quarter of the fp32 one. Values are bit-identical to
    the float path: PIL's resize output is uint8 either way, and u8→f32 is
    exact."""
    return np.asarray(resized_rgb(path, size), dtype=np.uint8)


def make_image_loader(cfg, raw: bool = False) -> Callable[[str], np.ndarray]:
    fam = cfg.backbone_family()
    size = (cfg.backbone_config or {}).get("input_size", 224)
    if raw:
        if fam not in ("layoutlmv3", "layoutlmv2"):
            raise ValueError(f"backbone family {fam} takes no image input")
        return lambda p: load_rgb_u8(p, size)
    if fam == "layoutlmv3":
        return lambda p: layoutlmv3_preprocess(p, size)
    if fam == "layoutlmv2":
        return lambda p: layoutlmv2_preprocess(p, size)
    raise ValueError(f"backbone family {fam} takes no image input")


def device_image_normalize(image: torch.Tensor, family: str) -> torch.Tensor:
    """The device half of the raw-uint8 loader: (B, H, W, 3) uint8 RGB → the
    normalized (B, 3, H, W) float32 tensor the models take. The same IEEE
    fp32 operations as the host loaders (:func:`layoutlmv3_preprocess`,
    :func:`layoutlmv2_preprocess`), so raw and host-normalized serving give
    bit-identical inputs. (torch is imported here, not with the module: the
    host half runs in preprocessing workers that import no torch.)"""
    import torch

    x = image.to(torch.float32)
    if family == "layoutlmv3":
        # a device tensor as the divisor: by a Python scalar, CUDA
        # multiplies by its rounded reciprocal, which is not numpy's quotient
        x = (x / x.new_tensor(255.0) - 0.5) / 0.5
    elif family == "layoutlmv2":
        x = x.flip(-1)  # RGB→BGR, raw 0-255 (the model normalizes it)
    else:
        raise ValueError(f"backbone family {family} takes no image input")
    return x.permute(0, 3, 1, 2)  # NHWC→NCHW
