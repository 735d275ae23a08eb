"""Intrinsics and calibration schemas, SO(3)/SE(3) helpers, the config
tree, the precision policy and the device rule (port of
repas_tpu/core)."""
from repas_tpu_torch.core.calib import (
    Intrinsics,
    Extrinsics,
    load_intrinsics_json,
    load_extrinsics_json,
    load_calibration_npz,
    save_intrinsics_json,
    scale_intrinsics,
    build_K,
)
from repas_tpu_torch.core import transforms
from repas_tpu_torch.core.config import (
    DetectorConfig,
    PnPConfig,
    DepthConfig,
    ICPConfig,
    RansacConfig,
    CanopyConfig,
    CalibrationConfig,
    CropConfig,
    CadConfig,
    PipelineConfig,
)

__all__ = [
    "Intrinsics", "Extrinsics",
    "load_intrinsics_json", "load_extrinsics_json", "load_calibration_npz",
    "save_intrinsics_json", "scale_intrinsics", "build_K", "transforms",
    "DetectorConfig", "PnPConfig", "DepthConfig", "ICPConfig", "RansacConfig",
    "CanopyConfig", "CalibrationConfig", "CropConfig", "CadConfig",
    "PipelineConfig",
]
