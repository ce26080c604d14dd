"""The check's readings over many seeds in one process: the program as
the cell runs it, its control (``fp8``: the reference in float8 in the
program's place) and faults planted in the program
(:mod:`benchmark.tools.faults`, from decoder position ``--fault-start``).

    python3 benchmark/tools/readings.py --workload decode-av-beam5 \\
        --seeds 1,2,3 --controls fp8,kv_unwritten --control-seeds 1 \\
        --fault-start 5

For each seed: set-up without the warm pass, then one whole pass (the
window at 0 seconds) of the program and its check, the control's check
of the same hypotheses, and a pass and a check with each fault planted;
one JSON line each, with each number compared, the pass's exit steps
and the lengths of the checked hypotheses. The lower reading of a limit is the largest the program
gives, the upper the smallest its control gives."""

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="fp8")
    p.add_argument("--fault-start", type=int, default=0)
    p.add_argument("--control-seeds", default="",
                   help="seeds the controls run on (default: --seeds)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=None)
    a = p.parse_args()
    from benchmark.harness import check, device, spec
    from benchmark.tools import faults
    cell = spec.load_cell(a.workload, a.bench)
    dev = device.acquire(a.device, 1)
    drv = spec.driver_module(cell)
    control_seeds = set(map(int, (a.control_seeds or a.seeds).split(",")))
    for seed in map(int, a.seeds.split(",")):
        run = drv.Decode(cell, seed, dev)
        run.setup(warm=False)
        for control in [""] + a.controls.split(","):
            if control and seed not in control_seeds:
                continue
            fault = control if control in faults.FAULTS else ""
            if control and not fault and getattr(run, "results", None):
                # the control scores the program's hypotheses of this seed
                report(run, seed, control, check.decode_scores(
                    run, cell.limits, control))
                continue
            take_out = faults.plant(fault, a.fault_start) if fault else None
            try:
                run.window(0)
            finally:
                if take_out:
                    take_out()
            report(run, seed, control, check.decode_scores(
                run, cell.limits, "" if fault else control))
        run.release()
        shutil.rmtree(run.tmp, ignore_errors=True)


def report(run, seed, control, checks):
    from benchmark.harness import check
    attempted = run.obs["passes"][-1]["turns"]
    longest = [max(len(w.split()) for w, _ in h)
               for h in run.results[-1].values()]
    print(json.dumps({
        "seed": seed, "control": control or "none",
        "checks": {c["name"]: c["value"] for c in checks},
        "correct": check.passed(checks) and
        attempted == len(run.results[-1]),
        "exit_steps": run.obs["passes"][-1]["mean_exit_step"],
        "mean_longest_hyp": sum(longest) / len(longest),
        "checked_tokens": run.obs["checked_tokens"],
        "checked_lengths": run.obs.get("checked_lengths"),
        "gap_stats": run.obs.get("gap_stats")}), flush=True)

if __name__ == "__main__":
    main()
