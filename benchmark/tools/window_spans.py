"""Windows of a decode cell with the program's span recorder off and on,
in one process.

    python3 benchmark/tools/window_spans.py --workload decode-av-beam5 \\
        --seed 7 --seconds 30 --order 0110 --out spans.json

After the cell's set-up (as ``run.py`` makes it), one window per
character of ``--order``: ``0`` as ``run.py --trace 0`` measures it,
``1`` with each pass under ``mtn_tpu_torch.utils.profiling.recording``.
Each window gives its ``decode_responses_per_s`` (responses over the
window's seconds); a traced window's passes carry their span summaries
(:func:`benchmark.harness.spans.pass_summary`), and the window the six
readings of :func:`benchmark.harness.spans.readings`, the idle seconds
under the tracer's own spans, its idle seconds by host span (the
passes' summed with ``between_passes``), and the driven spans' seconds
and kernel ms (the eager batch, the capture's warm-up) over its passes.
Every pass's n-bests are compared with the first pass's. One JSON line a
window on stdout; ``--out`` keeps them with every pass."""

import argparse
import json
import os
import sys
import time

T0 = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--order", default="0110",
                   help="a window per character: 0 untraced, 1 traced")
    p.add_argument("--out", default="")
    a = p.parse_args()
    from benchmark import run as bench
    bench.fixed_caches()
    from benchmark.harness import device, spans, spec
    from mtn_tpu_torch.utils import profiling
    cell = spec.load_cell(a.workload)
    dev = device.acquire("cuda", cell.chips)
    run = spec.driver_module(cell).run(
        cell, argparse.Namespace(seed=a.seed, control=""), dev)
    run.setup()
    head = {"workload": a.workload, "seed": a.seed,
            "setup_s": time.monotonic() - T0,
            "card": device.card_line() if dev.type == "cuda" else "cpu"}
    print(json.dumps(head), flush=True)
    untraced, first, windows = run.one_pass, None, []
    for mode in a.order:
        recs = []

        def traced(dataset=None):
            with profiling.recording() as rec:
                out = untraced(dataset)
            recs.append(rec.records())
            return out
        run.one_pass = traced if mode == "1" else untraced
        run.window(a.seconds)
        passes, window_s = run.obs["passes"], run.obs["window_s"]
        for entry, r in zip(passes, recs):
            entry["spans"] = spans.pass_summary(r)
        first = first if first is not None else run.results[0]
        w = {"traced": mode == "1", "window_s": window_s,
             "passes": len(passes),
             "decode_responses_per_s": sum(
                 e["responses"] for e in passes) / window_s,
             "first_batch_seconds": [e["first_batch_seconds"]
                                     for e in passes],
             "same_nbest": all(r == first for r in run.results)}
        if recs:
            w["readings"] = spans.readings(passes, window_s)
            idle = {"between_passes": spans.between_passes(passes, window_s)}
            for e in passes:
                for k, v in e["spans"]["idle_by_host"].items():
                    idle[k] = idle.get(k, 0.0) + v
            w["idle_by_host"] = idle
            w["tracer_idle_s"] = sum(e["spans"]["tracer_idle_s"]
                                     for e in passes)
            driven = {}
            for e in passes:
                for k, v in e["spans"]["driven"].items():
                    mine = driven.setdefault(k, {"s": [], "kernel_ms": []})
                    for f in ("s", "kernel_ms"):
                        mine[f] += v[f]
            w["driven"] = driven
            w["per_pass"] = [brief(e) for e in passes]
            w["worst_balance"] = max(
                abs(s["device_busy_s"] + sum(s["idle_by_host"].values())
                    - s["pass_s"]) / s["pass_s"]
                for s in (e["spans"] for e in passes))
            w["device_outside_pass"] = sum(
                e["spans"]["device_outside_pass"] for e in passes)
        print(json.dumps({k: v for k, v in w.items() if k != "per_pass"}),
              flush=True)
        windows.append(w)
    run.one_pass = untraced
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(dict(head, windows=windows), f)


def brief(entry: dict) -> dict:
    """One traced pass in brief: its times, busy and idle seconds, the
    host seconds by span, the graphed batches' device ms (each, in
    launch order) and the root's counters with the exit steps' mean."""
    s = entry["spans"]
    counters = dict(s["counters"])
    steps = counters.pop("exit_steps", [])
    return {"seconds": entry["seconds"], "pass_s": s["pass_s"],
            "first_batch_seconds": entry["first_batch_seconds"],
            "device_busy_s": s["device_busy_s"],
            "idle_by_host": s["idle_by_host"], "host_s": s["host_s"],
            "host_n": s["host_n"],
            "graphed_ms": s["graphed_batch_device_ms"],
            "driven": s["driven"],
            "counters": dict(counters, mean_exit_step=sum(steps) / len(
                steps) if steps else None)}


if __name__ == "__main__":
    main()
