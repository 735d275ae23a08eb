"""Standalone ICP / global registration between two geometries (port of
repas_tpu/apps/refine_icp.py): RANSAC+FPFH global init, point-to-plane
refine, optional second round on the top Y-fraction.

  python -m repas_tpu_torch.apps.refine_icp --source cad.stl \
      --target scene.ply --out registered.ply [--global] [--device cuda]

RANSAC draws its hypotheses from a torch generator seeded by the attempt
number, not from the reference's threefry stream, so a --global run lands
on another hypothesis than the reference's (each near the truth).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repas_tpu_torch.apps._common import add_device_arg, emit_json, log
from repas_tpu_torch.cloud.cad import refine_with_icp
from repas_tpu_torch.core.config import ICPConfig, RansacConfig
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import (PointCloud, TriangleMesh, read_geometry,
                                    write_ply)


def _as_cloud(geom, n=50_000, seed=0) -> np.ndarray:
    if isinstance(geom, TriangleMesh):
        return geom.sample_points_uniformly(n, seed=seed).points
    pts = geom.points
    if len(pts) > n:
        pts = pts[np.random.default_rng(seed).choice(len(pts), n,
                                                     replace=False)]
    return pts


def _console_approve(prompt: str) -> bool:
    """Console approval (the reference's PyQt5 -> AppleScript -> console
    fallback chain, icp_cad_model.py:120-173; only the console tier makes
    sense headless)."""
    try:
        ans = input(f"{prompt} [y/N]: ").strip().lower()
    except EOFError:
        return True
    return ans in ("y", "yes")


def global_register(src_pts, tgt_pts, cfg: RansacConfig = RansacConfig(),
                    seed: int = 0, device=None):
    """RANSAC + FPFH global registration (icp_cad_model.py:62-96):
    voxel = cfg.voxel_frac_of_diag * AABB diagonal; FPFH radius = 5*voxel;
    distance checker at 2.5*voxel, through the package recipe
    (cloud.registration.global_register_fpfh) on `device`."""
    from repas_tpu_torch.cloud.registration import global_register_fpfh

    both = np.concatenate([src_pts, tgt_pts])
    diag = float(np.linalg.norm(both.max(0) - both.min(0)))
    voxel = max(cfg.voxel_frac_of_diag * diag, 1e-3)
    T, fitness, _ = global_register_fpfh(
        np.asarray(src_pts, np.float32), np.ones(len(src_pts), bool),
        np.asarray(tgt_pts, np.float32), np.ones(len(tgt_pts), bool),
        voxel, n_hypotheses=cfg.hypothesis_batch,
        edge_check=cfg.edge_length_check, seed=seed, device=device)
    return T, fitness, voxel


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", type=Path, required=True)
    p.add_argument("--target", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--global", dest="global_init", action="store_true",
                   help="RANSAC+FPFH global init before ICP")
    p.add_argument("--max-corr", type=float, default=0.05)
    p.add_argument("--top-fraction", type=float, default=0.0,
                   help="second-round ICP on the top Y-fraction of both "
                        "clouds (icp_cad_model.py two-round refinement)")
    p.add_argument("--approve", action="store_true",
                   help="ask for human approval of the global registration;"
                        " on reject, reseed RANSAC and retry (up to 3x,"
                        " icp_cad_model.py:201-214 semantics)")
    p.add_argument("--json", type=Path)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    src_geom = read_geometry(args.source)
    tgt_geom = read_geometry(args.target)
    tgt_pts = _as_cloud(tgt_geom)

    T_total = np.eye(4)
    report = {}
    if args.global_init:
        src_pts = _as_cloud(src_geom)
        for attempt in range(3):
            T_g, fit, voxel = global_register(src_pts, tgt_pts,
                                              seed=attempt, device=dev)
            log.info("global registration fitness %.3f (voxel %.4f)",
                     fit, voxel)
            if not args.approve or _console_approve(
                    f"accept global registration (fitness {fit:.3f})?"):
                break
            log.info("rejected; reseeding RANSAC (attempt %d)", attempt + 2)
        T_total = T_g
        report["global"] = {"fitness": fit, "voxel": voxel,
                            "T": T_g.tolist()}
        src_geom = src_geom.transformed(T_g)

    icp_cfg = ICPConfig(max_corr_dist=args.max_corr)
    icp_report, T_icp = refine_with_icp(src_geom, PointCloud(points=tgt_pts),
                                        icp_cfg, device=dev)
    T_total = T_icp @ T_total
    report["icp"] = icp_report
    log.info("ICP fitness=%.3f rmse=%.4f", icp_report["fitness"],
             icp_report["inlier_rmse"])

    if args.top_fraction > 0:
        # second-round ICP on the top fraction along Y
        # (icp_cad_model.py:244-312: crop both clouds to their top
        # Y-fraction, re-run ICP, compose T2 = delta_icp @ T)
        src2 = read_geometry(args.source).transformed(T_total)
        s_pts = _as_cloud(src2)
        frac = args.top_fraction

        def top_y(p):
            lo, hi = p[:, 1].min(), p[:, 1].max()
            return p[p[:, 1] <= lo + frac * (hi - lo)]
        s_top = top_y(s_pts)
        t_top = top_y(tgt_pts)
        if len(s_top) > 100 and len(t_top) > 100:
            rep2, T2 = refine_with_icp(PointCloud(points=s_top),
                                       PointCloud(points=t_top), icp_cfg,
                                       device=dev)
            T_total = T2 @ T_total
            report["icp_top_fraction"] = rep2
            log.info("top-fraction ICP fitness=%.3f rmse=%.4f",
                     rep2["fitness"], rep2["inlier_rmse"])

    report["T_total"] = T_total.tolist()

    out_geom = read_geometry(args.source).transformed(T_total)
    write_ply(args.out, out_geom)
    write_meta(args.out.with_suffix(".meta.json"), "cad_transform", **report)
    emit_json(report, args.json)


if __name__ == "__main__":
    main()
