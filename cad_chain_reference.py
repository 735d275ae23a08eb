#!/usr/bin/env python3
"""The JAX package's refine_icp --global on chip_smoke.py's cad_chain files.

    python3 chip_smoke.py --keep DIR          # on a GPU host
    JAX_PLATFORMS=cpu python3 cad_chain_reference.py DIR

Runs ``repas_tpu.apps.refine_icp --global`` (the reference, on the CPU)
from DIR/moved.ply (the placed CAD moved by chip_smoke's known motion)
onto DIR/crop.ply and prints one JSON line: its translation (mm) and
rotation (degrees) error against that motion, beside the port's from
DIR/reg.json. chip_smoke.py's refine_icp gate (CAD_REG_T_MM,
CAD_REG_R_DEG) is set from this run.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None) -> int:
    from repas_tpu.apps import refine_icp
    from repas_tpu.io.ply import read_geometry

    from chip_smoke import motion_error

    d = Path((argv or sys.argv[1:])[0])
    refine_icp.main(["--source", str(d / "moved.ply"), "--target",
                     str(d / "crop.ply"), "--out",
                     str(d / "reference_registered.ply"), "--json",
                     str(d / "reference_reg.json"), "--global"])
    placed = read_geometry(d / "placed.ply").points
    ref = json.loads((d / "reference_reg.json").read_text())
    port = json.loads((d / "reg.json").read_text())
    out = {}
    for name, reg in (("reference", ref), ("port", port)):
        t_mm, r_deg = motion_error(reg["T_total"], placed)
        out[name] = {"t_err_mm": t_mm, "R_err_deg": r_deg,
                     "global_fitness": reg["global"]["fitness"],
                     "icp_fitness": reg["icp"]["fitness"],
                     "icp_iterations": reg["icp"]["iterations"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
