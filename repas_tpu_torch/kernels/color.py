"""Camera color-format conversion.

Port of ``repas_tpu/kernels/color.py`` (``_yuv_to_rgb``, ``nv12_to_rgb``,
``yuyv_to_rgb``, ``mjpg_to_rgb``, ``frame_to_rgb``). NV12 and YUYV
convert on the device in one elementwise pass (BT.601 limited range, as
OpenCV's COLOR_YUV2RGB_NV12 / _YUYV to rounding); MJPG is a host JPEG
decode (PIL, imported only when a MJPG frame comes). ``nv12_to_rgb`` and
``yuyv_to_rgb`` are compiled steps (``core.jit``: one CUDA graph per
buffer shape on the card).
"""
from __future__ import annotations

import io

import numpy as np
import torch

from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.core.jit import jit


def _yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    y = y.to(torch.float32) - 16.0
    u = u.to(torch.float32) - 128.0
    v = v.to(torch.float32) - 128.0
    r = 1.164 * y + 1.596 * v
    g = 1.164 * y - 0.392 * u - 0.813 * v
    b = 1.164 * y + 2.017 * u
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)


@jit
def nv12_to_rgb(buf: torch.Tensor) -> torch.Tensor:
    """NV12 (H*3/2, W) uint8 planar buffer -> (H,W,3) RGB, on buf's
    device."""
    w = buf.shape[1]
    h = (buf.shape[0] * 2) // 3
    uv = buf[h:, :].reshape(h // 2, w // 2, 2)
    up = uv.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return _yuv_to_rgb(buf[:h, :], up[..., 0], up[..., 1])


@jit
def yuyv_to_rgb(buf: torch.Tensor) -> torch.Tensor:
    """YUYV422 (H, W*2) uint8 interleaved buffer -> (H,W,3) RGB, on buf's
    device."""
    h, w = buf.shape[0], buf.shape[1] // 2
    quads = buf.reshape(h, w // 2, 4)
    y = quads[..., 0::2].reshape(h, w)          # y0, y1 of each pair
    return _yuv_to_rgb(y, quads[..., 1].repeat_interleave(2, dim=1),
                       quads[..., 3].repeat_interleave(2, dim=1))


def mjpg_to_rgb(data: bytes) -> np.ndarray:
    """Host MJPG (JPEG) decode -> (H,W,3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def frame_to_rgb(buf, fmt: str, width: int, height: int,
                 device=None) -> np.ndarray:
    """Host frame buffer of stream format `fmt` -> (H,W,3) uint8 RGB
    numpy. NV12 and YUYV convert on `device` (default: the card; raises
    without one); rgb/bgr are reshaped and MJPG decoded on the host."""
    fmt = fmt.lower()
    if fmt in ("rgb", "rgb8"):
        return np.asarray(buf, dtype=np.uint8).reshape(height, width, 3)
    if fmt in ("bgr", "bgr8"):
        return np.asarray(buf, dtype=np.uint8).reshape(height, width,
                                                       3)[..., ::-1]
    if fmt in ("nv12", "yuyv", "yuy2"):
        dev = host_data_device(device)
        raw = np.asarray(buf, np.uint8)
        if fmt == "nv12":
            out = nv12_to_rgb(torch.from_numpy(
                raw.reshape(height * 3 // 2, width)).to(dev))
        else:
            out = yuyv_to_rgb(torch.from_numpy(
                raw.reshape(height, width * 2)).to(dev))
        return out.cpu().numpy()
    if fmt in ("mjpg", "mjpeg", "jpeg"):
        return mjpg_to_rgb(bytes(buf))
    raise ValueError(f"unsupported color format {fmt!r}")
