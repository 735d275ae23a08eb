"""Quality and timing of the reconstruction paths on the card.

Port of ``tools/reconstruct_compare.py``: FFT-Poisson (dims 128 and 256)
against ball pivoting on an oriented sphere cloud (r = 0.1 m, seed 0),
through ``cloud.reconstruct`` with the Poisson grid and the ball test on
the device and the mesh extraction and Delaunay on the host. One JSON
line per method:
  {"method": ..., "n_pts": ..., "wall_s": ..., "tris": ...,
   "rmse_mm": ..., "p95_mm": ...}
where rmse/p95 are the mesh vertices' distances from the true sphere,
so quality is measured against ground truth. wall_s is the host clock
around the whole call (its results come back to the host).

    python -m repas_tpu_torch.tools.reconstruct_compare [--n N] \\
        [--device cuda]

N defaults to 1,000,000 on the card and 200,000 on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repas_tpu_torch.cloud.reconstruct import (ball_pivot, mean_nn_spacing,
                                               reconstruct_surface)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.ply import PointCloud
from repas_tpu_torch.tools import card_line


def sphere_cloud(n, r=0.1, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return PointCloud(points=(v * r).astype(np.float32),
                      normals=v.astype(np.float32))


def vertex_err_mm(mesh, r=0.1):
    d = np.abs(np.linalg.norm(np.asarray(mesh.vertices), axis=1) - r)
    return (float(np.sqrt(np.mean(d ** 2)) * 1e3),
            float(np.quantile(d, 0.95) * 1e3))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Poisson vs ball pivoting on a "
                                "sphere cloud: one JSON line per method")
    p.add_argument("--n", type=int, default=None,
                   help="points (default 1,000,000 on the card, 200,000 on "
                        "the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    dev = host_data_device(args.device)
    print(card_line(dev), flush=True)
    n = args.n or (1_000_000 if dev.type == "cuda" else 200_000)
    pc = sphere_cloud(n)
    print(json.dumps({"backend": dev.type, "n_pts": n}), flush=True)

    for dim in (128, 256):
        t0 = time.perf_counter()
        mesh = reconstruct_surface(pc, dim=dim, device=dev)  # includes host
        dt = time.perf_counter() - t0                        # surface nets
        rmse, p95 = vertex_err_mm(mesh)
        print(json.dumps({"method": f"fft_poisson_{dim}", "n_pts": n,
                          "wall_s": round(dt, 2),
                          "tris": len(mesh.triangles),
                          "rmse_mm": round(rmse, 3),
                          "p95_mm": round(p95, 3)}), flush=True)

    t0 = time.perf_counter()
    sp = mean_nn_spacing(np.asarray(pc.points))
    mesh = ball_pivot(pc, radii=[0.8 * sp, 1.2 * sp, 1.6 * sp], device=dev)
    dt = time.perf_counter() - t0
    rmse, p95 = vertex_err_mm(mesh)
    print(json.dumps({"method": "ball_pivot", "n_pts": n,
                      "wall_s": round(dt, 2), "tris": len(mesh.triangles),
                      "rmse_mm": round(rmse, 3),
                      "p95_mm": round(p95, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
