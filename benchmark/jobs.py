"""Registration cells: ``register_clouds`` on pairs of full-frame clouds,
one job at a time.

Set-up draws a pool of pairs on the card from the seed: the target a
uniform sampling of a bumpy surface (``bumpy``), the source an independent
sampling of the same surface moved by a seeded rigid motion (of the
bench's size: 0.3086 rad and 87.7 mm) into its own frame, so no point of
the source is a moved target point. It runs the entry once (the kernel
build and the capture of every stage) and once more. The window runs
jobs back to back, each ended by reading its transform on the host;
``job_s`` is the window's seconds over the jobs it completed. The check
judges every job of the window against the reference.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.trace import traced

# repas_tpu_torch/bench.py: REG_RV (0.04, -0.06, 0.30), REG_T
# (0.06, -0.04, 0.05): the motion's angle and length
ANGLE = math.sqrt(0.04 ** 2 + 0.06 ** 2 + 0.30 ** 2)
SHIFT = math.sqrt(0.06 ** 2 + 0.04 ** 2 + 0.05 ** 2)


def bumpy(xy: torch.Tensor) -> torch.Tensor:
    """The bench's registration surface (``bumpy_scene``) made
    asymmetric: z = 0.08 sin(7x + 1.1) cos(5y + 0.7) + 0.25 x^2 over
    [-0.5, 0.5]^2. The bench's z = 0.08 sin(7x) cos(5y) + 0.05 x^2 is
    odd in x but for the bowl, so a half turn about y maps it onto itself
    within 12.5 mm, which RANSAC's 2.5-voxel inlier test (about 70 mm
    here) cannot tell from the true pose: half of the seeded motions
    registered onto that turn. The phases and the deeper bowl leave the
    surface no such turn."""
    x, y = xy[:, 0], xy[:, 1]
    return torch.stack([x, y, 0.08 * torch.sin(7 * x + 1.1)
                        * torch.cos(5 * y + 0.7) + 0.25 * x * x], 1)


def motion(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A seeded rotation (about an axis within about 17 degrees of z) and
    translation, of the bench's angle and length."""
    from benchmark.scene import axis_angle

    axis = np.array([*rng.uniform(-0.3, 0.3, 2), 1.0])
    d = rng.normal(size=3)
    return axis_angle(axis, ANGLE), SHIFT * d / np.linalg.norm(d)


class RegisterCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 reference):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.reference = reference
        self.n = cfg["registration"]["points"]
        self.results = {}      # job index -> (T, fitness, rmse, iters, ransac)
        self.warm_call_s = None

    def setup(self):
        from repas_tpu_torch.cloud.registration import register_clouds

        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 62)))
        self.pairs = []
        for _ in range(self.traffic["pool_pairs"]):
            R, t = motion(rng)
            tgt = bumpy(torch.rand((self.n, 2), generator=gen,
                                   device=self.device) - 0.5)
            other = bumpy(torch.rand((self.n, 2), generator=gen,
                                     device=self.device) - 0.5)
            Rt = torch.tensor(R, dtype=torch.float32, device=self.device)
            tt = torch.tensor(t, dtype=torch.float32, device=self.device)
            src = ((other - tt) @ Rt).contiguous()   # R^T (p - t), row-wise
            self.pairs.append((src, tgt, R, t))
        self.mask = torch.ones(self.n, dtype=torch.bool, device=self.device)
        self.job_seeds = [int(s) for s in rng.integers(2 ** 31, size=len(
            self.pairs))]
        self.entry = register_clouds
        with torch.inference_mode():
            t0 = time.perf_counter()
            self._job(0)
            self.warm_call_s = time.perf_counter() - t0
            self._job(1)

    def _job(self, i: int):
        p = i % len(self.pairs)
        src, tgt, _, _ = self.pairs[p]
        with record_function("bench.dispatch"):
            res, fit_g, _ = self.entry(src, self.mask, tgt, self.mask,
                                       seed=self.job_seeds[p])
        with record_function("bench.wait"):
            T = res.T.cpu().numpy().astype(np.float64)
            return (T, float(res.fitness), float(res.inlier_rmse),
                    int(res.iterations), float(fit_g))

    def _loop(self, seconds=None, n_jobs=None, record=True):
        done = 0
        t0 = time.perf_counter()
        while True:
            out = self._job(done)
            if record:
                self.results[done] = out
            done += 1
            t = time.perf_counter()
            if (n_jobs is not None and done >= n_jobs) or \
                    (seconds is not None and t - t0 >= seconds):
                return done, t - t0

    def window(self, seconds: float) -> dict:
        with torch.inference_mode():
            jobs, dt = self._loop(seconds=seconds)
        return {"job_s": dt / jobs}

    def trace(self):
        with torch.inference_mode():
            return traced(lambda: self._loop(
                n_jobs=self.traffic["trace_jobs"], record=False)[0])

    def context(self) -> dict:
        return {"batch": 1, "config": self.cfg, "traffic": self.traffic,
                "warm_call_s": self.warm_call_s,
                "icp_iterations": [r[3] for r in self.results.values()]}

    def attempted(self) -> int:
        return len(self.results)

    def release(self):
        from repas_tpu_torch.core import jit

        self.motions = [(R, t) for _, _, R, t in self.pairs]
        del self.pairs
        jit.clear_caches()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control: bool = False) -> dict:
        jobs = [(self.results[i], *self.motions[i % len(self.motions)])
                for i in sorted(self.results)]
        return self.reference.judge(jobs, control=control)
