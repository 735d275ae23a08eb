"""Host-side image I/O: 8-bit RGB and 16-bit depth PNGs.

Port of ``repas_tpu/io/image.py`` (host numpy).

Replaces the reference's cv2.imread/imwrite call sites. Uses the fast native
codec from repas_tpu_torch.io.native (built at first use), falling back
to PIL. Images are
returned as numpy arrays in **RGB** channel order (the framework convention;
the reference uses BGR because of OpenCV — conversion helpers provided).
Depth PNGs are 16-bit grayscale (e.g. realsense_d415i/testing_scripts/
aligned_outputs/*/depth_raw_*.png) storing millimeters.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def read_image(path) -> np.ndarray:
    """Read an image as uint8 RGB (H,W,3) or uint16 gray (H,W): the native
    codec first (PNG), then PIL; raises naming both when neither can."""
    from repas_tpu_torch.io import native

    arr = native.read_png(path) if str(path).endswith(".png") else None
    if arr is not None:
        return arr

    try:
        from PIL import Image
    except ImportError as e:
        why = ("refused the file" if native.available()
               else f"not built: {native.build_error}")
        raise RuntimeError(f"{path}: cannot decode: the native codec ({why})"
                           " and PIL (not installed) are both unavailable"
                           ) from e

    im = Image.open(Path(path))
    if im.mode in ("I;16", "I;16B", "I"):
        return np.asarray(im).astype(np.uint16)
    if im.mode == "L":
        return np.asarray(im)
    if im.mode != "RGB":
        im = im.convert("RGB")
    return np.asarray(im)


def write_image(path, arr: np.ndarray) -> None:
    """Write uint8 RGB/gray or uint16 gray PNG."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        Image.fromarray(arr).save(path)
    else:
        Image.fromarray(arr.astype(np.uint8)).save(path)


def read_depth_png(path, scale: float = 0.001) -> np.ndarray:
    """Read a 16-bit depth PNG and convert to float32 meters.

    Matches depth_to_meters (better_three_capture.py:118-125): u16 * scale.
    """
    raw = read_image(path)
    if raw.dtype != np.uint16:
        raise ValueError(f"{path}: expected 16-bit depth PNG, got {raw.dtype}")
    return raw.astype(np.float32) * np.float32(scale)


def write_depth_png(path, depth_m: np.ndarray, scale: float = 0.001) -> None:
    """Write float meters as a 16-bit millimeter PNG."""
    raw = np.clip(np.round(np.asarray(depth_m) / scale), 0, 65535).astype(np.uint16)
    write_image(path, raw)


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[..., ::-1])


bgr_to_rgb = rgb_to_bgr


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, matching cv2.cvtColor(..., COLOR_RGB2GRAY) rounding."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img
    w = np.array([0.299, 0.587, 0.114], dtype=np.float64)
    g = img[..., :3].astype(np.float64) @ w
    if img.dtype == np.uint8:
        return np.clip(np.round(g), 0, 255).astype(np.uint8)
    return g.astype(img.dtype)
