"""Dataclass config tree for the frame pipeline.

Port of ``repas_tpu/core/config.py`` (``DetectorConfig``, ``PnPConfig``,
``DepthConfig``, ``ICPConfig``, ``RansacConfig``, ``CropConfig``,
``CadConfig``, ``CanopyConfig``, ``CalibrationConfig``,
``PipelineConfig``): the same fields and defaults, limited to the
sub-configs the ported paths read (frame pipeline, registration, crop,
CAD placement, canopy height, checkerboard calibration).
``from_reference`` builds this tree, and ``tracker_config_from_reference``
the tracker's ``TrackerConfig``, from ``dataclasses.asdict`` of a
``repas_tpu`` config, so both packages can run the same knobs (the
system has no learned weights: its configs and the tag codebook are what
carries across).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Tuple


@dataclass(frozen=True)
class DetectorConfig:
    """AprilTag detector knobs (fixed-capacity, masked-slot formulation)."""

    family: str = "tag36h11"
    quad_decimate: float = 2.0
    quad_sigma: float = 0.0
    refine_edges: bool = True
    decode_sharpening: float = 0.25
    max_hamming: int = 2
    min_decision_margin: float = 10.0
    max_components: int = 48            # candidate dark regions per frame
    max_detections: int = 8             # decoded tags returned per frame
    min_area_px: float = 64.0
    max_area_frac: float = 0.45
    tile: int = 4                       # adaptive-threshold tile
    min_contrast: float = 10.0
    ccl_iters: int = 5                  # scan+stencil propagation rounds


@dataclass(frozen=True)
class PnPConfig:
    """PnP / pose solve."""

    tag_size_m: float = 0.0303
    method: str = "ippe_square"
    refine_iters: int = 8
    z_penalty: float = 1000.0
    try_all_orders: bool = True


@dataclass(frozen=True)
class DepthConfig:
    """Depth stream handling."""

    depth_scale: float = 0.001          # u16 -> meters
    center_win: int = 5                 # median window
    fallback_win: int = 11
    min_depth_m: float = 0.25
    max_depth_m: float = 8.0


@dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP (the reference's Open3D defaults)."""

    max_corr_dist: float = 0.05
    max_iters: int = 100
    rel_tol: float = 1e-6
    cad_samples: int = 50_000
    scene_voxel: float = 0.005
    normal_radius: float = 0.02
    normal_max_nn: int = 30


@dataclass(frozen=True)
class RansacConfig:
    """Global registration (FPFH + RANSAC)."""

    voxel_frac_of_diag: float = 0.02
    max_points: int = 1_000_000
    fpfh_radius_mult: float = 5.0
    max_iterations: int = 200_000
    edge_length_check: float = 0.9
    dist_check_mult: float = 2.5
    hypothesis_batch: int = 8192        # hypotheses scored in one batch


@dataclass(frozen=True)
class CropConfig:
    """Tag-anchored AABB crop: box offsets in the tag-local frame, m."""

    tag_ids: Tuple[int, ...] = (9, 16)
    anchor_id: int = 16
    dx_front: float = 0.0
    dx_back: float = 0.0
    dy_front: float = 0.0
    dy_back: float = 0.0
    dz_front: float = 0.0
    dz_back: float = 0.0
    pad_m: float = 0.0


@dataclass(frozen=True)
class CadConfig:
    """CAD placement."""

    units_to_meters: float = 0.001
    pre_rot_deg_zyx: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    center_on_origin: bool = False
    origin_offset_local: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    flip_z_tag_ids: Tuple[int, ...] = (9,)  # tag-9 180deg Z-flip fix


@dataclass(frozen=True)
class CanopyConfig:
    """Plant-height pipeline (canopy/height.py)."""

    canny_low: float = 50.0
    canny_high: float = 150.0
    hough_threshold: int = 50
    hough_min_line_len: float = 50.0
    hough_max_line_gap: float = 10.0
    min_coverage: float = 0.1           # line >= 10% of image width
    max_bar_angle_deg: float = 20.0
    grabcut_iters: int = 5
    # HSV green ranges: seed (refinement prior) and strict (apply_green_mask)
    green_seed_lo: Tuple[int, int, int] = (35, 40, 40)
    green_seed_hi: Tuple[int, int, int] = (85, 255, 255)
    green_lo: Tuple[int, int, int] = (35, 80, 30)
    green_hi: Tuple[int, int, int] = (85, 255, 255)
    morph_kernel: int = 3
    depth_win: int = 5
    depth_fallback_win: int = 11
    proc_decimate: int = 2   # 2-D stages at 1/dec resolution (depth
                             # lookups and 3-D math at full resolution)
    tip_reconstruct_iters: int = 16  # full-res geodesic growth of thin
                                     # leaf tips (canopy/height.py 4b)
    canopy_depth_win: int = 25       # plant-masked median window for the
                                     # canopy depth


@dataclass(frozen=True)
class CalibrationConfig:
    """Checkerboard calibration (calib/checkerboard.py)."""

    inner_cols: int = 19
    inner_rows: int = 19
    square_size_mm: float = 12.7
    num_views: int = 20
    solver_iters: int = 100
    solver_tol: float = 1e-6
    subpix_win: int = 5
    subpix_iters: int = 50
    subpix_tol: float = 1e-4


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level config tree of the ported paths."""

    detector: DetectorConfig = field(default_factory=DetectorConfig)
    pnp: PnPConfig = field(default_factory=PnPConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    icp: ICPConfig = field(default_factory=ICPConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    canopy: CanopyConfig = field(default_factory=CanopyConfig)
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    crop: CropConfig = field(default_factory=CropConfig)
    cad: CadConfig = field(default_factory=CadConfig)
    tag_ids: Tuple[int, ...] = (9, 16)
    anchor_id: int = 16


def _build(cls, d: dict):
    kw = {}
    for f in fields(cls):
        v = d[f.name]
        kw[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
    return cls(**kw)


def from_reference(cfg_dict: dict) -> PipelineConfig:
    """PipelineConfig from ``dataclasses.asdict`` of a repas_tpu
    ``PipelineConfig``; a missing field raises KeyError."""
    return PipelineConfig(
        detector=_build(DetectorConfig, cfg_dict["detector"]),
        pnp=_build(PnPConfig, cfg_dict["pnp"]),
        depth=_build(DepthConfig, cfg_dict["depth"]),
        icp=_build(ICPConfig, cfg_dict["icp"]),
        ransac=_build(RansacConfig, cfg_dict["ransac"]),
        canopy=_build(CanopyConfig, cfg_dict["canopy"]),
        calibration=_build(CalibrationConfig, cfg_dict["calibration"]),
        crop=_build(CropConfig, cfg_dict["crop"]),
        cad=_build(CadConfig, cfg_dict["cad"]),
        tag_ids=tuple(cfg_dict["tag_ids"]),
        anchor_id=cfg_dict["anchor_id"],
    )


def tracker_config_from_reference(cfg_dict: dict):
    """pose.track.TrackerConfig from ``dataclasses.asdict`` of a repas_tpu
    ``TrackerConfig``; a missing field raises KeyError."""
    from repas_tpu_torch.pose.track import TrackerConfig

    return _build(TrackerConfig, cfg_dict)
