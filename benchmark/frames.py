"""Frame cells: the compiled frame step, ``process_frames_jit``, under a
closed or an open loop.

Set-up renders a pool of distinct batches on the card from the seed
(``benchmark/scene.py``), captures the step at the cell's one shape and
runs the loop briefly. A batch's results (ids, valid slots, corners,
areas, per-tag and fused pose, the anchor) are copied to the host after
each step; the clouds of a seeded sample of batches are kept on the card
until the window has closed. The check judges a seeded sample of the
window's batches against the configuration's plain reference.

Loops (the traffic file's ``kind``):

  closed_frames  batches dispatched ahead, at most ``in_flight`` of them
                 queued; rate = frames whose results reached the host
                 over the window's seconds.
  open_frames    ``cameras`` frames due together every 1/``rate_hz``
                 seconds whatever the card does; each frame's latency is
                 from its due time to its results on the host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import scene
from benchmark.trace import traced

FIELDS = ("ids", "valid", "corners", "areas", "R", "t", "R_avg",
          "anchor_idx", "anchor_t", "anchor_P")


def pipeline_config(p: dict):
    """The program's PipelineConfig with the configuration's values."""
    from repas_tpu_torch.core.config import PipelineConfig

    c = PipelineConfig()
    return dataclasses.replace(
        c, anchor_id=p["anchor_id"],
        detector=dataclasses.replace(c.detector,
                                     max_detections=p["max_detections"],
                                     quad_decimate=p["quad_decimate"],
                                     ccl_iters=p["ccl_iters"]),
        pnp=dataclasses.replace(c.pnp, tag_size_m=p["tag_size_m"]),
        depth=dataclasses.replace(c.depth, depth_scale=p["depth_scale"],
                                  center_win=p["center_win"],
                                  fallback_win=p["fallback_win"]),
        cad=dataclasses.replace(c.cad, flip_z_tag_ids=tuple(p["flip_z_ids"])))


def _fields(out) -> dict:
    det, pose = out.detections, out.pose
    return dict(ids=det.ids, valid=det.valid, corners=det.corners,
                areas=det.areas, R=pose.R, t=pose.t, R_avg=pose.R_avg,
                anchor_idx=pose.anchor_idx, anchor_t=pose.anchor_t,
                anchor_P=pose.anchor_P_depth)


class FrameCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 reference):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.reference = reference
        self.cam = scene.Camera.from_config(cfg)
        self.pcfg = cfg["pipeline"]
        self.batch = traffic["batch"]
        self.results = {}           # batch index -> {field: numpy}
        self.clouds = {}            # batch index -> device cloud
        self.send_lags = []
        self.warm_call_s = None
        self.replays = 0            # steps dispatched
        self.traced_replays = 0     # steps dispatched in the traced run

    # ---- set-up -------------------------------------------------------
    def setup(self):
        from repas_tpu_torch.pipeline import process_frames_jit

        t = self.traffic
        rng = np.random.default_rng(self.seed)
        n_pool = t["pool_batches"]
        self.truth = scene.draw_frames(rng, self.cam, t,
                                       self.pcfg["tag_size_m"],
                                       self.pcfg["anchor_id"],
                                       n_pool * self.batch)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        rgbs, depths = scene.render(self.truth, self.cam,
                                    self.pcfg["tag_size_m"], gen, self.device)
        h, w = self.cam.height, self.cam.width
        self.rgbs = rgbs.reshape(n_pool, self.batch, h, w, 3)
        self.depths = depths.reshape(n_pool, self.batch, h, w)
        self.K = torch.tensor(self.cam.K, dtype=torch.float32,
                              device=self.device)
        self.dist = (None if self.cam.dist is None else torch.tensor(
            self.cam.dist, dtype=torch.float32, device=self.device))
        self.config = pipeline_config(self.pcfg)
        self.step = process_frames_jit
        # cloud batches: the window's first and a seeded few of the next
        # ``cloud_within`` batches
        n = t["cloud_batches"]
        self.keep_cloud = {0} | set(
            int(i) for i in rng.choice(np.arange(1, t["cloud_within"]),
                                       size=n - 1, replace=False))
        self.sample_rng = np.random.default_rng(rng.integers(2 ** 62))
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = self.step(self.rgbs[0], self.depths[0], self.K, self.config,
                            dist=self.dist)
            out.pose.anchor_P_depth.cpu()
            self.warm_call_s = time.perf_counter() - t0
            # the loop itself, briefly: replays, host copies, events
            self._closed(n_batches=2 * n_pool, record=False)

    # ---- the loops ----------------------------------------------------
    def _dispatch(self, i: int, keep: bool):
        p = i % self.rgbs.shape[0]
        self.replays += 1
        with record_function("bench.dispatch"):
            out = self.step(self.rgbs[p], self.depths[p], self.K, self.config,
                            dist=self.dist)
            host = {k: v.to("cpu", non_blocking=True)
                    for k, v in _fields(out).items()}
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
        return i, (out.pointcloud if keep else None), host, ev

    def _finish(self, item, record: bool):
        i, pc, host, ev = item
        if ev is not None:
            with record_function("bench.wait"):
                ev.synchronize()
        if record:
            self.results[i] = {k: v.numpy() for k, v in host.items()}
            if pc is not None:
                self.clouds[i] = pc

    def _closed(self, seconds=None, n_batches=None, record=True,
                mark=False):
        """Closed loop for `seconds` (or `n_batches` completions).
        Returns (frames completed, seconds). With `mark`, a
        ``bench.window`` label spans the loop from its queue's first
        completion (the queue primed, the device busy) to its last."""
        in_flight = self.traffic["in_flight"]
        q = deque()
        i = done = 0
        label = record_function("bench.window") if mark else None
        t0 = time.perf_counter()
        while True:
            while len(q) < in_flight:
                q.append(self._dispatch(i, record and i in self.keep_cloud))
                i += 1
            self._finish(q.popleft(), record)
            if label is not None and done == 0:
                label.__enter__()
            done += 1
            t = time.perf_counter()
            if (n_batches is not None and done >= n_batches) or \
                    (seconds is not None and t - t0 >= seconds):
                break
        if label is not None:
            label.__exit__(None, None, None)
        while q:                    # after the window: not counted
            self._finish(q.popleft(), False)
        return done * self.batch, t - t0

    def _open(self, seconds, record=True):
        """Open loop: a batch due every 1/rate_hz s for `seconds`. Returns
        each batch's latency from its due time; with `record` keeps each
        send lag (how late the batch was handed to the step)."""
        period = 1.0 / self.traffic["rate_hz"]
        n_due = int(round(seconds / period))
        q = deque()
        k = 0
        t0 = time.perf_counter() + 0.01
        lat, lags = [], []
        while k < n_due or q:
            now = time.perf_counter()
            due = t0 + k * period
            if k < n_due and now >= due:
                lags.append(now - due)
                q.append((due, self._dispatch(k, record and k in
                                              self.keep_cloud)))
                k += 1
                continue
            if q and (q[0][1][3] is None or q[0][1][3].query()):
                d, item = q.popleft()
                self._finish(item, record)
                lat.append(time.perf_counter() - d)
                continue
            with record_function("bench.sleep"):
                time.sleep(min(2e-4, max(0.0, due - now)) if k < n_due
                           else 2e-4)
        if record:
            self.send_lags = lags
        return lat

    # ---- what the harness calls ---------------------------------------
    def window(self, seconds: float) -> dict:
        with torch.inference_mode():
            if self.traffic["kind"] == "closed_frames":
                frames, dt = self._closed(seconds=seconds)
                return {"frames_per_s": frames / dt}
            lat = self._open(seconds)
        # every frame of a batch has the batch's latency
        per_frame = np.repeat(np.asarray(lat) * 1e3, self.batch)
        return {"frame_latency_p95_ms": float(np.percentile(per_frame, 95))}

    def trace(self):
        t = self.traffic
        start = self.replays
        with torch.inference_mode():
            if t["kind"] == "closed_frames":
                # the window holds the steps completed after the first;
                # the trace also holds the first and the queue's drain
                tr = traced(lambda: self._closed(
                    n_batches=t["trace_batches"] + 1, record=False,
                    mark=True)[0] // self.batch - 1, mark=False)
            else:
                tr = traced(lambda: len(self._open(t["trace_seconds"],
                                                   record=False)))
        self.traced_replays = self.replays - start
        return tr

    def context(self) -> dict:
        return {"batch": self.batch, "height": self.cam.height,
                "width": self.cam.width, "config": self.cfg,
                "traffic": self.traffic, "warm_call_s": self.warm_call_s,
                "send_lags_s": self.send_lags,
                "replays": self.traced_replays}

    def attempted(self) -> int:
        return len(self.results) * self.batch

    def release(self):
        """Keeps on the host what the check reads and frees the rest."""
        from repas_tpu_torch.core import jit

        done = sorted(self.results)
        k = min(self.traffic["judge_batches"], len(done))
        pick = set(int(i) for i in self.sample_rng.choice(done, k,
                                                         replace=False))
        pick |= set(self.clouds)
        self.pick = sorted(i for i in pick if i in self.results)
        pools = sorted({i % self.rgbs.shape[0] for i in self.pick})
        self.host_rgbs = {p: self.rgbs[p].cpu().numpy() for p in pools}
        self.host_depths = {p: self.depths[p].cpu().numpy() for p in pools}
        self.host_clouds = {i: pc.cpu().numpy() for i, pc in
                            self.clouds.items() if i in self.results}
        del self.rgbs, self.depths, self.clouds
        jit.clear_caches()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(program outputs, truth, rgbs, depths, clouds) of the judged
        frames, with a leading frame axis."""
        res = {k: [] for k in FIELDS}
        truth, rgbs, depths, clouds = [], [], [], {}
        P = self.traffic["pool_batches"]
        for i in self.pick:
            p = i % P
            for b in range(self.batch):
                f = len(truth)
                for k in FIELDS:
                    res[k].append(self.results[i][k][b])
                truth.append(self.truth[p * self.batch + b])
                rgbs.append(self.host_rgbs[p][b])
                depths.append(self.host_depths[p][b])
                if i in self.host_clouds:
                    clouds[f] = self.host_clouds[i][b]
        return ({k: np.stack(v) for k, v in res.items()}, truth, rgbs,
                depths, clouds)

    def readings(self, control: bool = False) -> dict:
        res, truth, rgbs, depths, clouds = self.sample()
        if control:
            res, clouds = self.reference.control(
                truth, self.cam, self.pcfg, rgbs, depths, sorted(clouds),
                self.pcfg["max_detections"])
        return self.reference.judge(res, truth, self.cam, self.pcfg, rgbs,
                                    depths, clouds)
