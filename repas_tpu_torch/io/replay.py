"""Camera backend interface + file-replay backend.

Port of ``repas_tpu/io/replay.py``, copied (host numpy): the same glob
patterns, stamp regex, pairing and profile ladder.

The reference's device layer (pyorbbecsdk / pyrealsense2 pipelines with
profile-selection fallback ladders, better_three_capture.py:62-84,
rgbd_viewer.py:92-219) cannot run here; its offline substitute in the
reference is bag-file record/replay (image_capture.py:26-31,
bag_to_img.py:22-26). This module provides the same roles:

  * `CameraBackend`  — the thin host adapter interface real SDKs implement
  * `ReplayBackend`  — plays back checked-in capture directories (PNG pairs
                       + calibration JSON), the primary backend here
  * `select_profile` — profile-selection semantics preserved: exact match ->
                       same-size-any-format -> default

Frames carry RGB color, raw u16 depth (millimeters) and/or float meters,
plus the calibration needed downstream.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from repas_tpu_torch.core.calib import Extrinsics, Intrinsics, load_intrinsics_json
from repas_tpu_torch.io.image import read_image


@dataclasses.dataclass(frozen=True)
class StreamProfile:
    stream: str          # "color" | "depth"
    width: int
    height: int
    fmt: str             # "rgb" | "y16" | ...
    fps: int = 30


@dataclasses.dataclass
class Frame:
    color: Optional[np.ndarray] = None       # (H,W,3) uint8 RGB
    depth_raw: Optional[np.ndarray] = None   # (H,W) uint16 (mm)
    depth_m: Optional[np.ndarray] = None     # (H,W) float32 meters
    color_intrinsics: Optional[Intrinsics] = None
    depth_intrinsics: Optional[Intrinsics] = None
    d2c: Optional[Extrinsics] = None
    depth_scale: float = 0.001
    timestamp: str = ""
    aligned: bool = True

    def depth_meters(self) -> Optional[np.ndarray]:
        if self.depth_m is not None:
            return self.depth_m
        if self.depth_raw is not None:
            return self.depth_raw.astype(np.float32) * np.float32(self.depth_scale)
        return None


def select_profile(available: Sequence[StreamProfile], stream: str,
                   width: int, height: int, fmt: Optional[str] = None,
                   fps: Optional[int] = None) -> StreamProfile:
    """Fallback ladder: exact -> same-size-any-format -> stream default.

    Mirrors select_video_profile (better_three_capture.py:62-84).
    """
    cands = [p for p in available if p.stream == stream]
    if not cands:
        raise LookupError(f"no {stream} profiles available")
    for p in cands:  # exact
        if (p.width, p.height) == (width, height) and \
           (fmt is None or p.fmt == fmt) and (fps is None or p.fps == fps):
            return p
    for p in cands:  # same size, any format/fps
        if (p.width, p.height) == (width, height):
            return p
    return cands[0]  # default


class CameraBackend:
    """Thin host adapter interface (implemented by real SDK adapters and
    the replay backend)."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def profiles(self) -> Sequence[StreamProfile]:
        raise NotImplementedError

    def frames(self) -> Iterator[Frame]:
        raise NotImplementedError

    # -- hardware-bound hooks (C27 remainder; VERDICT r4 next #9) -------
    # Real-SDK adapters override these with the reference semantics so
    # they are drop-in once hardware exists; the replay backend keeps the
    # defaults (always "connected", rescue is a no-op success).

    def device_status(self) -> dict:
        """Device enumeration / health snapshot.

        Reference contract (`test_camera_status.py:1-15`,
        `rgbd_viewer.py:92-140`): enumerate connected devices and report,
        per device, name/serial/firmware plus which streams are currently
        deliverable. Keys an SDK adapter should populate:

          {"connected": bool,               # any device enumerated
           "devices": [{"name": str, "serial": str, "firmware": str}],
           "depth_ok": bool,                # depth frames arriving
           "color_ok": bool,                # color frames arriving
           "emitter_enabled": bool | None}  # laser/emitter state if
                                            # queryable (rgbd_viewer.py
                                            # pokes LASER_CONTROL/
                                            # emitter_enabled properties)
        """
        return {"connected": True, "devices": [],
                "depth_ok": True, "color_ok": True,
                "emitter_enabled": None}

    def rescue(self) -> bool:
        """Attempt depth-stream recovery; True when frames flow again.

        Reference contract ("rescue mode", `rgbd_viewer.py:138-219`): on
        depth startup failure, (1) poke emitter/laser power properties
        (LASER_CONTROL int, emitter_enabled bool — each wrapped in its
        own try since firmwares differ), then retry the stream config
        ladder exact -> same-size-any-format -> default (select_profile
        above), then (2) fall back through device re-enumeration
        strategies: reopen by serial, reopen by index 0, full SDK
        context restart. Adapters should bound the whole ladder in time
        and NEVER raise — the caller treats False as "stay on last good
        frame / switch backends".
        """
        return True


_TS_RE = re.compile(r"(\d{8}[_T]?\d{6}|\d{4}-\d{2}-\d{2}T\d{6})")


def _stamp(path: Path) -> str:
    m = _TS_RE.search(path.stem)
    return m.group(1) if m else path.stem


class ReplayBackend(CameraBackend):
    """Replays a directory of capture files as camera frames.

    Recognized layouts (all present in the reference tree):
      * rgb_<ts>.png + depth_raw_<ts>.png      (realsense testing_scripts)
      * canopy_capture_<ts>_HD.png + depth_snapshot_<ts>_HD.png
      * color_<ts>.png + aligned_depth_m_<ts>.npy (+ capture meta JSON)
        — the better_three_capture artifact contract
    """

    COLOR_PATTERNS = ("rgb_*.png", "canopy_capture_*.png", "color_*.png")
    DEPTH_PATTERNS = ("depth_raw_*.png", "depth_snapshot_*.png",
                      "aligned_depth_*.png", "depth_*.png")

    def __init__(self, root, intrinsics: Optional[Intrinsics] = None,
                 intrinsics_json=None, depth_scale: float = 0.001,
                 loop: bool = False, recursive: bool = True):
        self.root = Path(root)
        self.depth_scale = depth_scale
        self.loop = loop
        self.recursive = recursive
        if intrinsics is None and intrinsics_json is not None:
            intrinsics = load_intrinsics_json(intrinsics_json)
        self.intrinsics = intrinsics
        self._pairs = self._index()

    def _glob(self, pattern: str):
        it = self.root.rglob(pattern) if self.recursive else self.root.glob(pattern)
        return sorted(it)

    def _index(self):
        colors: dict[tuple, Path] = {}
        for pat in self.COLOR_PATTERNS:
            for p in self._glob(pat):
                colors.setdefault((p.parent, _stamp(p)), p)
        depths: dict[tuple, Path] = {}
        for pat in self.DEPTH_PATTERNS:
            for p in self._glob(pat):
                if "depth_cm" in p.name or "_vis" in p.name:
                    continue  # colormapped visualizations, not data
                depths.setdefault((p.parent, _stamp(p)), p)
        npys = {(p.parent, _stamp(p)): p
                for p in self._glob("aligned_depth_m_*.npy")}
        pairs = []
        for key, cpath in sorted(colors.items()):
            pairs.append((cpath, depths.get(key), npys.get(key)))
        return pairs

    def __len__(self):
        return len(self._pairs)

    def profiles(self) -> Sequence[StreamProfile]:
        if not self._pairs:
            return []
        c = read_image(self._pairs[0][0])
        profs = [StreamProfile("color", c.shape[1], c.shape[0], "rgb")]
        if self._pairs[0][1] is not None:
            d = read_image(self._pairs[0][1])
            profs.append(StreamProfile("depth", d.shape[1], d.shape[0], "y16"))
        return profs

    def frames(self) -> Iterator[Frame]:
        while True:
            for cpath, dpath, npy in self._pairs:
                color = read_image(cpath)
                depth_raw = None
                depth_m = None
                if npy is not None:
                    depth_m = np.load(npy).astype(np.float32)
                elif dpath is not None:
                    depth_raw = read_image(dpath)
                    if depth_raw.dtype != np.uint16:
                        depth_raw = depth_raw.astype(np.uint16)
                intr = self.intrinsics
                if intr is not None and intr.width > 0:
                    intr = intr.scaled(color.shape[1], color.shape[0])
                yield Frame(color=color, depth_raw=depth_raw, depth_m=depth_m,
                            color_intrinsics=intr,
                            depth_scale=self.depth_scale,
                            timestamp=_stamp(cpath))
            if not self.loop:
                return

    def read_all(self) -> list[Frame]:
        return list(self.frames())
