"""Runs one cell of ``BENCHMARK.json`` and prints its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program (``repas_tpu_torch``)
and a CUDA card. The run sets up the cell (its inputs from the seed on
the card, the compiled step captured, the loop warmed), measures for
``--seconds``, and with ``--trace 1`` traces a further short stretch of
the same loop for the per-layer metrics. It then frees the program's
state and checks a seeded sample of the window's outputs against the
configuration's plain reference. The last lines of standard error name
each number compared beside its limit; the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``breakdown``) and ``checks``.

Without a card, with fewer cards than the cell asks for, without the
program, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# whole top-level module names a run must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repas_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _workload_class(driver: str):
    """The class a traffic mix names as "module:Class" (``benchmark.*``)."""
    import importlib

    mod, name = driver.split(":")
    if not mod.startswith("benchmark."):
        raise ValueError(f"a driver lives in the benchmark, not {mod!r}")
    return getattr(importlib.import_module(mod), name)


def run_cell(spec, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """Sets up, measures, traces and checks one cell; returns the result
    object (without printing it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    reference = spec.reference(traffic["reference"])
    work = _workload_class(traffic["driver"])(cfg, traffic, seed, device,
                                            reference)
    work.setup()
    setup_s = time.perf_counter() - t_start
    e2e = work.window(seconds)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {}
    if trace:
        tr = work.trace()
        ctx = dict(work.context(), trace=tr)
        metrics = {}
        for m in spec.per_layer(cell["name"]):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in spec.end_to_end(cell["name"])}
    work.release()
    readings = work.readings(control=control)
    limits = cfg["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in readings.items()}
    failed = int(readings.get("tags_wrong", 0) + readings.get(
        "anchor_wrong", 0))
    return dict(correct=all(c["value"] <= c["limit"]
                            for c in checks.values()),
                attempted=work.attempted(), failed=failed, metrics=metrics,
                device=dev, **result, checks=checks)


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's and PyTorch's build and kernel caches stay inside the
    # checkout, at fixed paths (the kernels build into build/kernels)
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    import torch

    from benchmark.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        import repas_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here: {e}", file=sys.stderr)
        return 2
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_line()}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
