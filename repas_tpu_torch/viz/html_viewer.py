"""Self-contained interactive HTML point-cloud/mesh viewer.

Port of ``repas_tpu/viz/html_viewer.py``, copied (host numpy): the
same template, subsampling and framing, so the file is byte-identical.

The reference's interactive viewing path is an Open3D window
(o3d.visualization.draw_geometries, e.g. view_pointcloud.py /
final_view_with_cad.py:258-262: rotate/zoom/pan a captured cloud). No
display server exists in this deployment environment, so the repas-tpu
equivalent writes ONE self-contained .html file — point data embedded as
base64, a dependency-free WebGL renderer inline (no CDN fetches; works
offline) — giving the same rotate / zoom / pan / point-size interaction
in any browser.

Used by `view_pointcloud --html out.html` and available as a library
call for capture/debug tooling.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>repas-tpu viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;font-family:monospace}
 #hud{position:fixed;left:10px;top:10px;color:#9f9;font-size:12px;
      background:rgba(0,0,0,.5);padding:6px 8px;border-radius:4px;user-select:none}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">__TITLE__ — __NPTS__ pts · drag: rotate · wheel: zoom ·
shift-drag: pan · +/-: point size</div>
<canvas id="c"></canvas>
<script>
"use strict";
const B64 = "__DATA__";
const META = __META__;
const raw = (() => {
  const bin = atob(B64);
  const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return bytes.buffer;
})();
const N = META.n;
const pos = new Float32Array(raw, 0, N * 3);
const col = new Uint8Array(raw, N * 12, N * 3);

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
uniform float ps; varying vec3 vc;
void main(){ gl_Position = mvp * vec4(p,1.0); gl_PointSize = ps; vc = c; }`;
const fs = `precision mediump float; varying vec3 vc;
void main(){ gl_FragColor = vec4(vc, 1.0); }`;
function sh(type, src){ const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
function buf(data, loc, size, type, norm){
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW);
  gl.enableVertexAttribArray(loc);
  gl.vertexAttribPointer(loc, size, type, norm, 0, 0); }
buf(pos, gl.getAttribLocation(prog, "p"), 3, gl.FLOAT, false);
buf(col, gl.getAttribLocation(prog, "c"), 3, gl.UNSIGNED_BYTE, true);
const uMVP = gl.getUniformLocation(prog, "mvp");
const uPS = gl.getUniformLocation(prog, "ps");
gl.enable(gl.DEPTH_TEST);

// --- tiny mat4 helpers (column-major) ---
function mul(a, b){ const o = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++){
    let s = 0; for (let k = 0; k < 4; k++) s += a[k*4+j]*b[i*4+k];
    o[i*4+j] = s; } return o; }
function persp(fov, asp, near, far){ const f = 1/Math.tan(fov/2);
  return new Float32Array([f/asp,0,0,0, 0,f,0,0,
    0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]); }
function trans(x,y,z){ return new Float32Array([1,0,0,0,0,1,0,0,0,0,1,0,x,y,z,1]); }
function rotx(a){ const c=Math.cos(a),s=Math.sin(a);
  return new Float32Array([1,0,0,0, 0,c,s,0, 0,-s,c,0, 0,0,0,1]); }
function roty(a){ const c=Math.cos(a),s=Math.sin(a);
  return new Float32Array([c,0,-s,0, 0,1,0,0, s,0,c,0, 0,0,0,1]); }

let az = 0.5, el = 0.4, dist = META.radius * 2.5, psize = 2.0;
let panX = 0, panY = 0;
const ctr = META.center;
let drag = null;
canvas.addEventListener("mousedown", e => drag = {x: e.clientX, y: e.clientY, shift: e.shiftKey});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => { if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.shift){ panX += dx * dist * 0.001; panY -= dy * dist * 0.001; }
  else { az += dx * 0.008; el += dy * 0.008;
         el = Math.max(-1.55, Math.min(1.55, el)); }
  drag.x = e.clientX; drag.y = e.clientY; draw(); });
canvas.addEventListener("wheel", e => { e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001); draw(); });
window.addEventListener("keydown", e => {
  if (e.key === "+" || e.key === "=") psize = Math.min(12, psize + 1);
  if (e.key === "-") psize = Math.max(1, psize - 1);
  draw(); });

function draw(){
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h){ canvas.width = w; canvas.height = h; }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.07, 0.07, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  let m = trans(-ctr[0], -ctr[1], -ctr[2]);
  m = mul(roty(az), m);
  m = mul(rotx(el), m);
  m = mul(trans(panX, panY, -dist), m);
  m = mul(persp(0.9, w/h, META.radius*0.01, META.radius*50), m);
  gl.uniformMatrix4fv(uMVP, false, m);
  gl.uniform1f(uPS, psize);
  gl.drawArrays(gl.POINTS, 0, N);
}
window.addEventListener("resize", draw);
draw();
</script></body></html>
"""


def write_html_viewer(path, points: np.ndarray, colors: np.ndarray = None,
                      title: str = "point cloud",
                      max_points: int = 400_000) -> Path:
    """Write a self-contained interactive viewer for (N,3) points with
    optional (N,3) colors (float [0,1] or uint8). Subsamples uniformly
    past max_points. Returns the written path."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(pts)
    if colors is None:
        cols = np.full((n, 3), 200, np.uint8)
    else:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(np.asarray(cols, np.float64) *
                           (255.0 if cols.max() <= 1.5 else 1.0),
                           0, 255).astype(np.uint8)
        cols = cols.reshape(-1, 3)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
        n = max_points

    # robust framing: RGB-D captures are bimodal — a nearby subject plus
    # far background walls/outliers (measured: 75% of points within
    # 1.2 m, max 65 m, on a 0.7 m capture). Frame the subject: median
    # center, radius = 1.5x the 75th-percentile distance.
    center = np.median(pts, axis=0)
    radius = float(1.5 * np.percentile(
        np.linalg.norm(pts - center, axis=1), 75) + 1e-9)
    blob = pts.astype("<f4").tobytes() + cols.tobytes()
    meta = {"n": int(n), "center": [float(c) for c in center],
            "radius": radius}
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__NPTS__", f"{n:,}")
            .replace("__META__", json.dumps(meta))
            .replace("__DATA__", base64.b64encode(blob).decode()))
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(html)
    return p
