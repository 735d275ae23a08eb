"""The reference's own canopy algorithm (cv2 GrabCut) on canopy captures.

Port of ``tools/canopy_reference_parity.py``: ``rotate_info`` and
``reference_canopy`` as written there (the reference's bar-edge rotate
-> green-seeded GrabCut -> strict green mask -> highest plant pixel ->
5x5 median depth -> deproject to the canopy's Y), with the same cv2
calls and constants, run over five GrabCut seeds per capture. It prints
what the JAX tool prints: one line per capture with the truth and the Y
range over the seeds, then every capture's values as JSON.

Each capture is ``canopy_capture_<stamp>_HD.png`` (colour),
``depth_snapshot_<stamp>_HD.png`` (u16 mm) and ``canopy_y_<stamp>.txt``
(the truth in m) under the captures directory.

    python -m repas_tpu_torch.tools.canopy_reference_parity \\
        --captures DIR [--stamps STAMP ...]

Host-only OpenCV code: no device work, so no ``--device``. cv2 is
imported when a function runs, so the package imports without it.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np

STAMPS = ["2025-11-14T143013", "2025-11-14T143028",
          "2025-11-14T143037", "2025-11-14T143042"]
# the JAX tool's stand-in intrinsics (fx ~910 at 720p)
FX, FY, CX, CY = 912.35, 911.78, 628.78, 348.98


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("canopy_reference_parity needs OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


def rotate_info(bgr):
    """canopy_return.py detect_rotate_aluminum_bar_edges semantics."""
    cv2 = _cv2()
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    blurred = cv2.GaussianBlur(gray, (5, 5), 0)
    edges = cv2.Canny(blurred, 50, 150)
    lines = cv2.HoughLinesP(edges, rho=1, theta=np.pi / 180, threshold=50,
                            minLineLength=50, maxLineGap=10)
    if lines is None:
        return None, bgr
    for line in lines:
        x1, y1, x2, y2 = np.ravel(line)[:4]   # cv2 5.0: (N,4); 4.x: (N,1,4)
        length = math.hypot(x2 - x1, y2 - y1)
        ang = math.degrees(math.atan2(y2 - y1, x2 - x1))
        if length > bgr.shape[1] * 0.1 and (abs(ang) < 20 or abs(ang) > 160):
            h, w = bgr.shape[:2]
            M = cv2.getRotationMatrix2D((w // 2, h // 2), ang, 1.0)
            rot = cv2.warpAffine(bgr, M, (w, h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=(255, 255, 255))
            return M, rot
    return None, bgr


def reference_canopy(bgr, depth_mm, seed):
    """GrabCut pipeline -> {"Y", "row_rot", "orig", "z"}, or None when no
    plant pixel or no valid depth near it is found."""
    cv2 = _cv2()
    cv2.setRNGSeed(seed)
    M, rot = rotate_info(bgr)

    hsv = cv2.cvtColor(rot, cv2.COLOR_BGR2HSV)
    green = cv2.inRange(hsv, (35, 40, 40), (85, 255, 255))
    gmask = np.where(green == 255, cv2.GC_PR_FGD, cv2.GC_BGD).astype("uint8")
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    h, w = rot.shape[:2]
    cv2.grabCut(rot, gmask, (1, 1, w - 2, h - 2), bgd, fgd, 5,
                cv2.GC_INIT_WITH_MASK)
    fg = ((gmask == cv2.GC_FGD) | (gmask == cv2.GC_PR_FGD)).astype("uint8")
    plant = rot * fg[:, :, None]

    hsv2 = cv2.cvtColor(plant, cv2.COLOR_BGR2HSV)
    strict = cv2.inRange(hsv2, (35, 80, 30), (85, 255, 255))
    k = np.ones((3, 3), np.uint8)
    strict = cv2.morphologyEx(strict, cv2.MORPH_OPEN, k)
    strict = cv2.morphologyEx(strict, cv2.MORPH_CLOSE, k)
    colored = cv2.bitwise_and(plant, plant, mask=strict)

    mask = np.any(colored != 0, axis=2)
    if not mask.any():
        return None
    ys, xs = np.where(mask)
    cy_rot = int(ys.min())
    cx_rot = int(np.median(xs[ys == cy_rot]))

    if M is not None:
        inv = cv2.invertAffineTransform(M)
        p = cv2.transform(np.array([[[cx_rot, cy_rot]]], np.float32), inv)
        ox, oy = int(p[0, 0, 0]), int(p[0, 0, 1])
    else:
        ox, oy = cx_rot, cy_rot

    dh, dw = depth_mm.shape
    x = max(0, min(ox, dw - 1))
    y = max(0, min(oy, dh - 1))
    for win in (5, 11):
        hw = win // 2
        d = depth_mm[max(0, y - hw):y + hw + 1, max(0, x - hw):x + hw + 1]
        v = d[d > 0]
        if len(v):
            z = float(np.median(v)) / 1000.0
            break
    else:
        return None
    Y = (oy - CY) * z / FY
    return {"Y": Y, "row_rot": cy_rot, "orig": (ox, oy), "z": z}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The reference's cv2 GrabCut canopy algorithm on "
        "canopy captures, over five GrabCut seeds each.")
    p.add_argument("--captures", required=True,
                   help="directory of the canopy captures")
    p.add_argument("--stamps", nargs="+", default=STAMPS,
                   help="capture stamps (default: the reference's four)")
    args = p.parse_args(argv)
    cv2 = _cv2()
    base = args.captures
    out = {}
    for stamp in args.stamps:
        bgr = cv2.imread(f"{base}/canopy_capture_{stamp}_HD.png")
        depth = cv2.imread(f"{base}/depth_snapshot_{stamp}_HD.png",
                           cv2.IMREAD_UNCHANGED)
        with open(f"{base}/canopy_y_{stamp}.txt") as f:
            truth = float(f.read())
        runs = [reference_canopy(bgr, depth, seed) for seed in range(5)]
        runs = [r for r in runs if r is not None]
        ys = sorted(r["Y"] for r in runs)
        rows = sorted(r["orig"][1] for r in runs)
        out[stamp] = {
            "truth": truth,
            "ref_algo_Y": ys,
            "ref_algo_rows": rows,
            "ref_algo_z": [round(r["z"], 4) for r in runs],
        }
        print(f"{stamp}: truth={truth:+.4f}  "
              f"ref Y over 5 seeds: {min(ys):+.4f}..{max(ys):+.4f}  "
              f"rows {rows[0]}..{rows[-1]}", flush=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
