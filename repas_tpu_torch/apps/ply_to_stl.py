"""Point-cloud PLY -> STL surface reconstruction (port of
repas_tpu/apps/ply_to_stl.py): strict geometry classify, normals,
reconstruction, cleanup, STL + meta.

  python -m repas_tpu_torch.apps.ply_to_stl INPUT.ply OUTPUT.stl [--dim 128]
  python -m repas_tpu_torch.apps.ply_to_stl INPUT.ply OUTPUT.stl --method alpha

Reconstruction paths, mirroring the reference's BPA-or-Poisson choice
(ply_to_stl.py:65-91): "poisson" (FFT screened-Poisson + surface nets,
smooths noise, watertight), "alpha" (alpha-shape direct triangulation
of the samples — the BPA-family method: exact input vertices, pivot-ball
radius from mean NN spacing) and "bpa" (ball pivoting, auto radii).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repas_tpu_torch.apps._common import add_device_arg, log
from repas_tpu_torch.cloud.reconstruct import (alpha_shape, ball_pivot,
                                               reconstruct_surface)
from repas_tpu_torch.core.device import host_data_device
from repas_tpu_torch.io.meta import write_meta
from repas_tpu_torch.io.ply import TriangleMesh, read_geometry, write_stl


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path)
    p.add_argument("--dim", type=int, default=128,
                   help="reconstruction grid resolution (poisson)")
    p.add_argument("--method", choices=["poisson", "alpha", "bpa"],
                   default="poisson")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="alpha ball radius (0 = auto from NN spacing)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = host_data_device(args.device)

    geom = read_geometry(args.input)
    if isinstance(geom, TriangleMesh):
        log.info("input is already a mesh (%d tris); converting directly",
                 len(geom.triangles))
        mesh = geom
        method = "passthrough"
    else:
        log.info("reconstructing surface from %d points", len(geom))
        if args.method == "alpha":
            mesh = alpha_shape(geom, alpha=args.alpha or None)
            method = f"alpha_shape(alpha={args.alpha or 'auto'})"
        elif args.method == "bpa":
            # the reference's default method (ply_to_stl.py:66-67, auto
            # radii 0.8/1.2/1.6x mean NN spacing)
            mesh = ball_pivot(geom, device=dev)
            method = "ball_pivot(auto radii)"
        else:
            mesh = reconstruct_surface(geom, dim=args.dim, device=dev)
            method = f"fft_poisson+surface_nets(dim={args.dim})"

    if len(mesh.triangles) == 0:
        raise SystemExit("reconstruction produced no triangles")
    write_stl(args.output, mesh)
    write_meta(args.output.with_suffix(".meta.json"), "stl",
               source=args.input, method=method,
               n_vertices=len(mesh.vertices),
               n_triangles=len(mesh.triangles))
    log.info("wrote %s (%d tris)", args.output, len(mesh.triangles))


if __name__ == "__main__":
    main()
