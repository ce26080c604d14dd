#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mtn_tpu_torch`` once.

    python3 benchmark/run.py --workload decode-av-beam5 --seed 7 \\
        --seconds 20 --trace 0

The cell, its configuration, its traffic mix, its limits and its metrics
are found by name from ``BENCHMARK.json`` (``benchmark/harness/spec.py``).
The run makes its inputs and weights from ``--seed``, warms up (set-up),
measures for ``--seconds`` (with ``--trace 1`` it also takes the cell's
per-layer readings), frees the program's state, checks what the window
produced against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics with ``--trace 0``, the per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines on stderr).

It exits 2, printing no result, without a CUDA card (``--device cpu``
runs the same path on the CPU, for the tests), and 3 if a module of
JAX or of the JAX package is loaded once the window has closed.
``--control fp8`` puts the reference computed in float8 in the program's
place for the check (the check's control; never in a measured run).
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--control", default="", choices=("", "fp8"))
    p.add_argument("--bench", default="",
                   help="another BENCHMARK.json (the tests' tiny cells)")
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import device, spec
    cell = spec.load_cell(args.workload, args.bench or None)
    try:
        dev = device.acquire(args.device, cell.chips)
    except device.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    import mtn_tpu_torch
    if not os.path.abspath(mtn_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"no result: mtn_tpu_torch is imported from "
              f"{mtn_tpu_torch.__file__}, outside this checkout",
              file=sys.stderr)
        return 2
    if dev.type == "cuda":
        print(f"card: {device.card_line()}", file=sys.stderr)
    run = spec.driver_module(cell).run(cell, args, dev)
    run.setup()
    run.obs["setup_s"] = time.monotonic() - T0
    run.window(args.seconds)
    if dev.type == "cuda":
        print(f"card after the window: {device.card_line()}",
              file=sys.stderr)
    if args.trace:
        run.trace()
    run.release()
    checks, attempted, failed = run.check()
    from benchmark.harness.check import passed
    correct = passed(checks) and failed == 0
    metrics = spec.read_metrics(cell.per_layer if args.trace
                                else cell.end_to_end, run.obs)
    dev_info = device.describe(dev, run.obs["memory_peak_bytes"])
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info}
    if args.trace and "held" in run.obs:
        dev_info["busy_s"] = run.obs["held"]["busy_s"]
        dev_info["window_s"] = run.obs["held"]["wall_s"]
        line["breakdown"] = {"device_ops": run.obs["device_ops"],
                             "idle_gaps": run.obs["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps({k: v for k, v in run.obs.items()
                      if k in ("setup_phases", "passes", "checked_tokens",
                               "checked_lengths",
                               "window_s", "held", "device_groups")}),
          file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    found = device.forbidden_modules()
    if found:
        print(f"no result: loaded after the window: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
