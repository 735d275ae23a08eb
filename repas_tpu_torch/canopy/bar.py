"""Aluminium-bar detection: Canny -> Hough -> rotation.

Port of ``repas_tpu/canopy/bar.py`` (``canny_edges``, ``HoughLine``,
``hough_horizontal_bar``, ``detect_bar``, ``detect_rotate_bar``). Canny:
blur, Sobel, direction-quantised non-max suppression, double threshold,
hysteresis by iterated 3x3 dilation of the strong edges through the weak
mask. Hough: edge pixels compacted to ``max_edges`` slots, one vote per
(angle, edge) pair into a (theta, rho) accumulator within the reference's
near-horizontal band, the peak's line endpoints from the edge pixels
within 2 px of it. Every function runs where its input lies and reads
nothing back to the host.

``canny_edges`` and ``hough_horizontal_bar`` are compiled steps
(``core.jit``, one CUDA graph per static key on the card), with the
reference's static arguments and its traced floats (``low``, ``high``;
``threshold``, ``min_line_frac``) as 0-d tensors. Two arguments the
reference traces are static here, so each value captures a graph of its
own: ``sigma``, from which ``kernels.image.gaussian_blur`` computes its
taps on the host, and ``max_angle_deg``, which keys the cached angle
tables (ROADMAP C).

The arithmetic follows XLA's CPU rounding of the reference where the
result is an integer decision or an endpoint (ROADMAP C, probed): the
rho of a vote is fma(x, cos, y*sin) + diag before its truncation to a
bin, the endpoints' projections and positions are FMAs too, and the default
angle band's cos/sin tables are the reference's float32 values
(``jnp.linspace`` and XLA's ``sin`` differ from torch's in a few
entries).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repas_tpu_torch.core.jit import jit, pin
from repas_tpu_torch.kernels.image import (_fma, dilate, gaussian_blur,
                                           get_rotation_matrix_2d,
                                           rgb_to_gray, sobel, warp_affine)

# cos and sin of the normal angles deg2rad(linspace(-20, 20, 41) + 90) as
# the reference computes them in float32 (its default band)
_COS_41_20 = tuple(float.fromhex(x) for x in (
    "0x1.5e3a88p-2", "0x1.4d61bcp-2", "0x1.3c6ef2p-2", "0x1.2b6382p-2",
    "0x1.1a40bp-2", "0x1.0907dep-2", "0x1.ef74cp-3", "0x1.ccb322p-3",
    "0x1.a9cd96p-3", "0x1.86c6e6p-3", "0x1.63a1aep-3", "0x1.4060bap-3",
    "0x1.1d06cap-3", "0x1.f32d4p-4", "0x1.ac25fep-4", "0x1.64fd7cp-4",
    "0x1.1db9p-4", "0x1.acbc7ep-5", "0x1.1de58cp-5", "0x1.1df09ap-6",
    "-0x1.777a5cp-25", "-0x1.1df078p-6", "-0x1.1de57ap-5", "-0x1.acbc6cp-5",
    "-0x1.1db8f8p-4", "-0x1.64fd72p-4", "-0x1.ac2616p-4", "-0x1.f32d36p-4",
    "-0x1.1d06c6p-3", "-0x1.4060b4p-3", "-0x1.63a1aap-3", "-0x1.86c6e2p-3",
    "-0x1.a9cd92p-3", "-0x1.ccb31ep-3", "-0x1.ef74bcp-3", "-0x1.0907dcp-2",
    "-0x1.1a40aep-2", "-0x1.2b638p-2", "-0x1.3c6efp-2", "-0x1.4d61bap-2",
    "-0x1.5e3a86p-2",
))
_SIN_41_20 = tuple(float.fromhex(x) for x in (
    "0x1.e11f64p-1", "0x1.e41b02p-1", "0x1.e6f0e2p-1", "0x1.e9a0c6p-1",
    "0x1.ec2a7ep-1", "0x1.ee8dd4p-1", "0x1.f0ca9ap-1", "0x1.f2e0a2p-1",
    "0x1.f4cfc4p-1", "0x1.f697d6p-1", "0x1.f838b8p-1", "0x1.f9b24ap-1",
    "0x1.fb046ap-1", "0x1.fc2f02p-1", "0x1.fd31fap-1", "0x1.fe0d3cp-1",
    "0x1.fec0b8p-1", "0x1.ff4c5ep-1", "0x1.ffb028p-1", "0x1.ffec0ap-1",
    "0x1p+0", "0x1.ffec0ap-1", "0x1.ffb028p-1", "0x1.ff4c5ep-1",
    "0x1.fec0b8p-1", "0x1.fe0d3cp-1", "0x1.fd31fap-1", "0x1.fc2f02p-1",
    "0x1.fb046ap-1", "0x1.f9b24ap-1", "0x1.f838b8p-1", "0x1.f697d6p-1",
    "0x1.f4cfc4p-1", "0x1.f2e0a2p-1", "0x1.f0ca9ap-1", "0x1.ee8dd4p-1",
    "0x1.ec2a7ep-1", "0x1.e9a0c6p-1", "0x1.e6f0e2p-1", "0x1.e41b04p-1",
    "0x1.e11f64p-1",
))


@functools.partial(jit, static_argnames=("hysteresis_iters", "sigma"),
                   scalar_argnames=("low", "high"))
def canny_edges(gray: torch.Tensor, low: float = 50.0, high: float = 150.0,
                sigma: float = 1.1, hysteresis_iters: int = 16
                ) -> torch.Tensor:
    """cv2.Canny(blurred, low, high) equivalent over (...,H,W) -> bool
    edge map. The reference blurs with GaussianBlur((5,5),0) first; sigma
    1.1 is OpenCV's default sigma for ksize 5."""
    g = gaussian_blur(gray.to(torch.float32), sigma, radius=2)
    gx, gy = sobel(g)
    mag = torch.sqrt(_fma(gx, gx, gy * gy))

    # non-max suppression along the quantised gradient direction
    a = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    p = torch.nn.functional.pad(mag, (1, 1, 1, 1))
    n = {
        0: (p[..., 1:-1, 2:], p[..., 1:-1, :-2]),          # E/W
        45: (p[..., :-2, 2:], p[..., 2:, :-2]),            # NE/SW
        90: (p[..., :-2, 1:-1], p[..., 2:, 1:-1]),         # N/S
        135: (p[..., :-2, :-2], p[..., 2:, 2:]),           # NW/SE
    }
    sel = torch.where(a < 22.5, 0,
                      torch.where(a < 67.5, 45,
                                  torch.where(a < 112.5, 90,
                                              torch.where(a < 157.5, 135,
                                                          0))))
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for q, (n1, n2) in n.items():
        keep = torch.where(sel == q, (mag >= n1) & (mag >= n2), keep)
    nms = torch.where(keep, mag, 0.0)

    strong = nms >= high
    weak = nms >= low
    for _ in range(hysteresis_iters):
        strong = strong | ((dilate(strong, 3) > 0) & weak)
    return strong


class HoughLine(NamedTuple):
    found: torch.Tensor        # () bool
    angle_deg: torch.Tensor    # signed angle of the segment (atan2 dy,dx)
    p0: torch.Tensor           # (2,) segment start (pixel)
    p1: torch.Tensor           # (2,) segment end
    coverage: torch.Tensor     # length / image width
    length: torch.Tensor


_TABLES = {}


def _angle_tables(n_theta: int, max_angle_deg: float, device):
    """(cos, sin) of the band's normal angles on `device`, made once per
    device (a host-to-device copy waits for the queue); a captured step
    that reads them keeps them alive (``core.jit.pin``)."""
    key = (n_theta, float(max_angle_deg), torch.device(device))
    if key not in _TABLES:
        if n_theta == 41 and float(max_angle_deg) == 20.0:
            tables = (torch.tensor(_COS_41_20), torch.tensor(_SIN_41_20))
        else:
            theta = torch.deg2rad(torch.linspace(
                -max_angle_deg, max_angle_deg, n_theta) + 90.0)
            tables = (torch.cos(theta), torch.sin(theta))
        _TABLES[key] = tuple(t.to(torch.float32).to(device) for t in tables)
    return pin(_TABLES[key])


def _first_k_indices(flags: torch.Tensor, k: int):
    """The flat indices of the first k True entries of a 1-D bool tensor in
    index order (stable compaction by a prefix count, no host read), and a
    (k,) mask of the slots filled. The reference takes ``lax.top_k`` over
    the 0/1 indicator, which keeps the lowest indices among ties."""
    f = flags.to(torch.int64)
    pos = torch.cumsum(f, 0) - 1
    keep = (f > 0) & (pos < k)
    slot = torch.where(keep, pos, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=flags.device)
    idx.scatter_(0, slot, torch.arange(f.shape[0], device=flags.device))
    count = torch.clamp(f.sum(), max=k)
    valid = torch.arange(k, device=flags.device) < count
    return torch.where(valid, idx[:k], 0), valid


@functools.partial(jit, static_argnames=("n_theta", "rho_step", "max_edges",
                                         "max_angle_deg"),
                   scalar_argnames=("threshold", "min_line_frac"))
def hough_horizontal_bar(edges: torch.Tensor, threshold: int = 50,
                         min_line_frac: float = 0.1,
                         max_angle_deg: float = 20.0,
                         n_theta: int = 41, rho_step: float = 1.0,
                         max_edges: int = 16384) -> HoughLine:
    """The dominant near-horizontal line among the edge pixels of an (H,W)
    map: HoughLinesP specialised to the reference's filter (length >=
    min_line_frac * width, |angle| < max_angle_deg), only angles in the
    band binned; returns the longest qualifying line. The first
    ``max_edges`` edge pixels in index order vote."""
    h, w = edges.shape
    dev = edges.device
    idx, valid = _first_k_indices(edges.reshape(-1), max_edges)
    xs = (idx % w).to(torch.float32)
    ys = (idx // w).to(torch.float32)
    ct, st = _angle_tables(n_theta, max_angle_deg, dev)

    diag = float(math.hypot(h, w))
    n_rho = int(math.ceil(2 * diag / rho_step)) + 1

    # one scatter over all (theta, edge) pairs
    rho_all = _fma(xs[None, :].expand(n_theta, -1),
                   ct[:, None].expand(-1, max_edges),
                   ys[None, :] * st[:, None]) + diag
    b = torch.clamp((rho_all / rho_step).to(torch.int32), 0, n_rho - 1)
    flat_bins = (torch.arange(n_theta, dtype=torch.int64, device=dev)[:, None]
                 * n_rho + b)
    flat_bins = torch.where(valid[None, :], flat_bins, n_theta * n_rho)
    acc = torch.zeros(n_theta * n_rho + 1, dtype=torch.int32, device=dev)
    acc.index_add_(0, flat_bins.reshape(-1),
                   torch.ones(flat_bins.numel(), dtype=torch.int32,
                              device=dev))
    acc = acc[:-1]

    # the peak bin (the first maximum); one-element index tensors, since a
    # 0-d index tensor would be read back to the host
    flat = torch.argmax(acc).reshape(1)
    ti = flat // n_rho
    ri = flat % n_rho
    votes = acc.index_select(0, flat)[0]
    c, s = ct.index_select(0, ti)[0], st.index_select(0, ti)[0]
    ri = ri[0]
    rho = ri.to(torch.float32) * rho_step - diag

    # endpoints: edge pixels within 2 px of the line, min/max along it
    d = torch.abs(_fma(xs, c.expand_as(xs), ys * s) - rho)
    on = valid & (d < 2.0)
    tproj = _fma(ys, c.expand_as(ys), xs * -s)
    tmin = torch.amin(torch.where(on, tproj, math.inf))
    tmax = torch.amax(torch.where(on, tproj, -math.inf))
    tdir = torch.stack([-s, c])
    normal = torch.stack([c, s])
    # base + t * tdir with base = rho * normal, as XLA contracts it
    p0 = _fma(rho.expand(2), normal, tmin * tdir)
    p1 = _fma(rho.expand(2), normal, tmax * tdir)
    length = torch.clamp(tmax - tmin, min=0.0)
    coverage = length * (1.0 / w)
    dxy = p1 - p0
    angle = torch.rad2deg(torch.atan2(dxy[1], dxy[0]))
    # normalise to (-90, 90]
    angle = torch.where(angle > 90.0, angle - 180.0,
                        torch.where(angle <= -90.0, angle + 180.0, angle))
    found = ((votes >= threshold) & (coverage >= min_line_frac)
             & (torch.abs(angle) < max_angle_deg))
    return HoughLine(found=found, angle_deg=angle, p0=p0, p1=p1,
                     coverage=coverage, length=length)


def _bar_line(rgb, canny_low, canny_high, hough_threshold, min_coverage,
              max_bar_angle_deg):
    gray = rgb_to_gray(rgb)
    edges = canny_edges(gray, canny_low, canny_high)
    line = hough_horizontal_bar(edges, threshold=hough_threshold,
                                min_line_frac=min_coverage,
                                max_angle_deg=max_bar_angle_deg)
    h, w = gray.shape
    # the rotation by the bar's angle, or none when no bar was found
    angle = torch.where(line.found, line.angle_deg, 0.0)
    return line, get_rotation_matrix_2d((w // 2, h // 2), angle, 1.0)


def detect_bar(rgb: torch.Tensor, canny_low: float = 50.0,
               canny_high: float = 150.0, hough_threshold: int = 50,
               min_coverage: float = 0.1,
               max_bar_angle_deg: float = 20.0):
    """Bar line and rotation matrix, without warping the image: the
    rotated-frame row of any pixel is the affine form
    yr = M10 x + M11 y + M12, so the height pipeline projects mask pixels
    directly. rgb (H,W,3). Returns (line, M (2,3))."""
    return _bar_line(rgb, canny_low, canny_high, hough_threshold,
                     min_coverage, max_bar_angle_deg)


def detect_rotate_bar(rgb: torch.Tensor, canny_low: float = 50.0,
                      canny_high: float = 150.0, hough_threshold: int = 50,
                      min_coverage: float = 0.1,
                      max_bar_angle_deg: float = 20.0):
    """detect_rotate_aluminum_bar_edges equivalent. Returns (line, M (2,3),
    rotated_rgb): the image rotated by the bar angle about its centre with
    a white border, and the affine used (for inverse point mapping)."""
    line, M = _bar_line(rgb, canny_low, canny_high, hough_threshold,
                        min_coverage, max_bar_angle_deg)
    rotated = warp_affine(rgb.to(torch.float32), M, border_value=255.0)
    return line, M, rotated
