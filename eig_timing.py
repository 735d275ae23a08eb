#!/usr/bin/env python3
"""Device time and instruction mix of kernels K1 (3x3 eigh,
``csrc/eig3.cu``), K2 (3x3 Kabsch rotation, ``csrc/kabsch3.cu``) and K3
(9x9 eigh, ``csrc/eig9.cu``) of the PyTorch + CUDA port, beside another
checkout's, in turns.

    python3 eig_timing.py [--root DIR] [--reps N]

Compiles the three sources of this checkout and, with ``--root``, of DIR
(an unpacked older commit) into a library each under
``build/eig_timing/`` (one nvcc per source, all started together, the
port's flags), loads both with ctypes and calls their C entry points
directly on the same inputs, at the shapes of the port's paths:

* K1 on the covariances that ``register_clouds`` hands it on bench.py's
  1M registration scene (recorded from an eager call): the downsampled
  target's 8,192 (the capacity), one 65,536-matrix chunk of the 1M
  target's normals, and all 1M of them;
* K2 on what the same call hands it: one RANSAC draw's 8,192
  cross-covariances of point triples;
* K3 on what ``solve_pnp_sqpnp`` hands it (``chip_smoke.sqpnp_problems``):
  one problem's (1,9,9) float32 Omega and float64 DLT Gram, a batch of
  16 Omegas, and 4,096 Omegas (the bound's shape);
* K2 on the seeds the same SQPnP calls project to SO(3) (transposed, as
  ``pose.pnp._nearest_rotation_k2`` hands them): a batch of 16's (96,3,3)
  Omega seeds and (16,3,3) homography seeds, one problem's (6,3,3) and
  (1,3,3); and one zero matrix, which no sweep rotates (the launch, the
  I/O and the epilogue alone).

Each time is ``chip_smoke.cuda_ms``'s: the mean of 20 launches between
CUDA events, queued behind a spin kernel so that the host's gaps do not
count; the versions run in turns (other, this, this, other), ``--reps``
times. Each version's result is held against float64: K1's and K3's
eigenvalues against torch.linalg.eigh (the largest difference over the
largest |eigenvalue|), K2's rotations against ``kabsch3_plain`` (the
largest entry difference where the rotation is determined, as
``chip_smoke.check_k2_pnp`` decides it); its sweep counts are
histogrammed. Then each library's static instruction mix per kernel
(``cuobjdump -sass``: instructions, float64 ones, MUFU seeds, float64
conversions, shuffles, loads and stores by width, calls: the slow
paths of float64 divides, square roots and reciprocal square roots).
Prints the card's name and power limit, then one JSON line per shape and
version and one per kernel's mix. Needs a CUDA device and the CUDA
toolkit.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from chip_smoke import EIGH_BATCH, cuda_ms

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "eig_timing"
SOURCES = ("eig3.cu", "eig9.cu", "kabsch3.cu")


def build(label: str, root: Path) -> ctypes.CDLL:
    """Compile root's SOURCES into OUT/label/libeig.so."""
    from repas_tpu_torch.kernels._build import ARCH, NVCC_FLAGS, _nvcc

    out = OUT / label
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    csrc = root / "repas_tpu_torch" / "kernels" / "csrc"
    jobs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o",
                              str(out / f"{src}.o"), str(csrc / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for src in SOURCES]
    for proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        print(json.dumps({"build": label, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "stack frame" in ln]}), flush=True)
    subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(out / "libeig.so"),
                    *[str(out / f"{s}.o") for s in SOURCES]], check=True)
    lib = ctypes.CDLL(str(out / "libeig.so"))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repas_eig3.argtypes = [P, P, P, P, L, I, P]
    lib.repas_eig9.argtypes = [P, P, P, P, L, I, I, P]
    lib.repas_kabsch3.argtypes = [P, P, P, L, I, P]
    lib.repas_eig3.restype = lib.repas_eig9.restype = I
    lib.repas_kabsch3.restype = I
    return lib


def launcher(lib, kernel: str, A: torch.Tensor,
             sweeps: torch.Tensor | None = None):
    """A function launching lib's K1, K2 or K3 on A into fresh outputs:
    (w, V) of K1 and K3, R of K2."""
    n = A.shape[0]
    w = torch.empty(A.shape[:2], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    sw = 0 if sweeps is None else sweeps.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    dev = A.device.index

    def run():
        if kernel == "K2 kabsch3":
            rc = lib.repas_kabsch3(A.data_ptr(), V.data_ptr(), sw, n, dev,
                                   stream)
        elif kernel == "K1 eig3":
            rc = lib.repas_eig3(A.data_ptr(), w.data_ptr(), V.data_ptr(), sw,
                                n, dev, stream)
        else:
            rc = lib.repas_eig9(A.data_ptr(), w.data_ptr(), V.data_ptr(), sw,
                                n, int(A.dtype == torch.float64), dev,
                                stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return V if kernel == "K2 kabsch3" else (w, V)
    return run


def registration_inputs(dev) -> tuple[dict, dict]:
    """The covariances register_clouds hands K1 on the 1M scene, and the
    cross-covariances of one RANSAC draw it hands K2."""
    from repas_tpu_torch.bench import REG_N, REG_SEED, bumpy_scene
    from repas_tpu_torch.cloud import fpfh, normals
    from repas_tpu_torch.cloud import registration as reg
    from repas_tpu_torch.core.jit import disable_jit

    src_np, tgt_np, _, _ = bumpy_scene(REG_N)
    src = torch.from_numpy(src_np).to(dev)
    tgt = torch.from_numpy(tgt_np).to(dev)
    mask = torch.ones(REG_N, dtype=torch.bool, device=dev)
    seen = {"eig3": [], "kabsch3": []}
    saved = normals.eig3, fpfh.kabsch3

    def recorder(key, fn):
        def rec(A, *a, **k):
            seen[key].append(A.clone())
            return fn(A, *a, **k)
        return rec

    normals.eig3 = recorder("eig3", saved[0])
    fpfh.kabsch3 = recorder("kabsch3", saved[1])
    try:
        with disable_jit():
            reg.register_clouds(src, mask, tgt, mask, seed=REG_SEED)
    finally:
        normals.eig3, fpfh.kabsch3 = saved
    eig3 = seen["eig3"]
    return ({"capacity": eig3[0], "chunk": eig3[2],
             "target_1m": torch.cat(eig3[2:])},
            {"ransac_draw": seen["kabsch3"][0]})


def pnp_inputs(dev) -> tuple[dict, dict]:
    """The matrices solve_pnp_sqpnp hands K3, and the seeds it hands
    K2."""
    from repas_tpu_torch.pose import pnp

    k3, k2 = {}, {}
    for n, seed in ((1, 0), (16, 0), (4096, 1)):
        obj, img, K = chip_smoke.sqpnp_problems(n, seed=seed)
        with chip_smoke.pnp_inputs() as seen:
            pnp.solve_pnp_sqpnp_jit.fn(obj.to(dev), img.to(dev), K.to(dev))
        k3[f"omega_{n}"] = seen["eig9"][0]
        if n == 1:
            k3["dlt_gram_1"] = seen["eig9"][1]
        if n < 4096:
            k2[f"omega_seeds_{n}"] = seen["kabsch3"][0]
            k2[f"homography_seeds_{n}"] = seen["kabsch3"][1]
    # H = 0: no rotation, so the launch, the I/O and the epilogue alone
    k2["zero_1"] = torch.zeros(1, 3, 3, device=dev)
    return k3, k2


def rotation_err(H: torch.Tensor, R: torch.Tensor) -> float:
    """Largest |R - R64| entry where the nearest rotation is determined
    (chip_smoke.check_k2_pnp's rule), R64 the float64 plain version."""
    from repas_tpu_torch.kernels.kabsch3 import kabsch3_plain

    Hd = H.double()
    fixed = chip_smoke.kabsch3_determined(Hd, torch.linalg.svdvals(Hd))
    dR = (R.double() - kabsch3_plain(Hd)).abs().amax(dim=(1, 2))
    return float(dR[fixed].max()) if bool(fixed.any()) else 0.0


def eigval_err(A: torch.Tensor, w: torch.Tensor) -> float:
    """Largest |w - w64| over the largest |eigenvalue| of its matrix."""
    errs = []
    for s in range(0, A.shape[0], EIGH_BATCH):
        w64 = torch.linalg.eigvalsh(A[s:s + EIGH_BATCH].double())
        top = w64.abs().amax(1) + 1e-300
        errs.append(((w[s:s + EIGH_BATCH].double() - w64).abs().amax(1)
                     / top).max())
    return float(torch.stack(errs).max())


def sass_mix(lib_path: Path) -> dict:
    """Static instruction counts per kernel of a library (cuobjdump)."""
    from repas_tpu_torch.kernels._build import _nvcc

    tool = shutil.which("cuobjdump") or str(Path(_nvcc()).with_name(
        "cuobjdump"))
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    mixes, name = {}, None
    op = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            mixes[name] = collections.Counter()
            continue
        m = op.match(line)
        if m and name:
            mixes[name][m.group(1)] += 1
    out = {}
    for name, ops in mixes.items():
        if "eig" not in name and "kabsch" not in name:
            continue
        base = collections.Counter()
        for o, c in ops.items():
            base[o.split(".")[0]] += c
        out[name] = {
            "instructions": sum(ops.values()),
            "float64": sum(base[o] for o in ("DADD", "DMUL", "DFMA", "DSETP",
                                             "DMNMX")),
            "DFMA": base["DFMA"], "DMUL": base["DMUL"], "DADD": base["DADD"],
            "MUFU": {o: c for o, c in ops.items() if o.startswith("MUFU")},
            "F2F": base["F2F"], "SHFL": base["SHFL"],
            "loads": {o: c for o, c in ops.items()
                      if o.startswith(("LDG", "LDS"))},
            "stores": {o: c for o, c in ops.items()
                       if o.startswith(("STG", "STS"))},
            "CALL": base["CALL"], "BAR": base["BAR"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose kernels are timed beside these")
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of (other, this, this, other)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("eig_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    libs = {"this": build("this", ROOT)}
    if args.root:
        libs["other"] = build("other", Path(args.root).resolve())
    order = (["other", "this", "this", "other"] if args.root
             else ["this"]) * args.reps
    k1, k2_reg = registration_inputs(dev)
    k3, k2_pnp = pnp_inputs(dev)
    cases = [("K1 eig3", k, A) for k, A in k1.items()] + \
        [("K2 kabsch3", k, A) for k, A in {**k2_reg, **k2_pnp}.items()] + \
        [("K3 eig9", k, A) for k, A in k3.items()]
    torch.cuda.synchronize()
    for kernel, what, A in cases:
        runs = {v: launcher(libs[v], kernel, A) for v in libs}
        ms = {v: [] for v in libs}
        for v in order:
            ms[v].append(cuda_ms(runs[v], queued=True))
        for v, lib in libs.items():
            sweeps = torch.zeros(A.shape[0], dtype=torch.int32, device=dev)
            got = launcher(lib, kernel, A, sweeps)()
            torch.cuda.synchronize()
            err = ({"rotation_err_f64": rotation_err(A, got)}
                   if kernel == "K2 kabsch3" else
                   {"eigval_rel_err_f64": eigval_err(A, got[0])})
            print(json.dumps({
                "kernel": kernel, "input": what, "shape": list(A.shape),
                "dtype": str(A.dtype).split(".")[-1], "version": v,
                "root": str(args.root if v == "other" else "."),
                "ms": ms[v], **err,
                "sweeps": torch.bincount(sweeps).tolist()}), flush=True)
    for v in libs:
        for name, mix in sass_mix(OUT / v / "libeig.so").items():
            print(json.dumps({"sass": v, "function": name, **mix}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
