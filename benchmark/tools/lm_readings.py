"""The check's readings of a language-model decode cell over many seeds
in one process (``tools/readings.py``'s readings, for
``drivers/decode_lm.py``): the program as the cell runs it, its control
(``fp8``: the reference in float8 in the program's place) and faults
planted in the program (:data:`FAULTS`).

    python3 benchmark/tools/lm_readings.py \\
        --workload decode-kimivl-avsd-beam5 --seeds 1,2,3 \\
        --controls fp8,bias_ignored --control-seeds 1 --fault-start 5

For each seed: set-up without the warm pass, then one whole pass (the
window at 0 seconds, and the check's probe after it) of the program and
its check, the control's check of the same hypotheses, and a pass and a
check with each fault planted; one JSON line each, with every number
compared, the pass's seconds and the lengths of the checked hypotheses
(``--dump FILE`` appends each checked hypothesis's length and gap). The
lower reading of a limit is the largest the program gives, the upper
the smallest its control gives.

Faults, each of which has to come out as not correct:

- ``bias_ignored``: the routers select by their scores alone, without
  the correction bias;
- ``top5``: five experts a token instead of six;
- ``shared_left_out``: the MoE layers without their shared experts;
- ``rope_pad_inclusive``: RoPE positions count the pad slots of the
  uniform-shape prompt (the answer starting after all of them);
- ``kv_unwritten``: the latent cache of the generated tokens is not
  written from decoder position ``--fault-start`` on
  (``tools/faults.py``'s fault of the same name).

Not a fault: ``stream_bf16`` runs the program with the residual stream
in bf16 (``kimi_lm.RESIDUAL_DTYPE``), as the published model keeps it;
its line gives its pass's seconds and its gaps beside the f32 stream's.
"""

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _patch(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    return lambda: setattr(obj, name, old)


def plant(name: str, start: int = 0):
    """Plant the fault ``name``; returns a function that takes it out."""
    import torch
    from benchmark.tools import faults
    from mtn_tpu_torch.models import kimi_lm
    if name == "kv_unwritten":
        return faults.plant(name, start)
    if name == "bias_ignored":
        return _patch(kimi_lm, "route", lambda old: (
            lambda x, g, b, k, s, n: old(x, g, torch.zeros_like(b), k, s,
                                         n)))
    if name == "top5":
        return _patch(kimi_lm, "route", lambda old: (
            lambda x, g, b, k, s, n: old(x, g, b, k - 1, s, n)))
    if name == "shared_left_out":
        def routed_only(old):
            def forward(self, x, real=None, rows=None):
                w, idx = kimi_lm.route(
                    x, self.gate.weight, self.gate.e_score_correction_bias,
                    self.top_k, self.scaling, self.norm_topk)
                x = x.to(self.gate.weight.dtype)
                return kimi_lm.routed_experts(
                    x, w, idx, real, self.experts.gate_up_proj,
                    self.experts.down_proj, rows)
            return forward
        return _patch(kimi_lm.MoE, "forward", routed_only)
    if name == "stream_bf16":
        return _patch(kimi_lm, "RESIDUAL_DTYPE", lambda old: torch.bfloat16)
    if name == "rope_pad_inclusive":
        def every_slot(old):
            def positions(real):
                B, S = real.shape
                pos = torch.arange(S, device=real.device).expand(B, S)
                return pos, torch.full((B,), S, device=real.device)
            return positions
        return _patch(kimi_lm, "prompt_positions", every_slot)
    raise KeyError(f"no fault {name!r}; known: {FAULTS}")


FAULTS = ("bias_ignored", "top5", "shared_left_out", "rope_pad_inclusive",
          "kv_unwritten")


def report(run, seed: int, control: str, checks: list, dump=None) -> None:
    from benchmark.harness import check
    last = run.obs["passes"][-1]
    print(json.dumps({
        "seed": seed, "control": control or "none",
        "checks": {c["name"]: c["value"] for c in checks},
        "correct": check.passed(checks) and
        last["turns"] == len(run.results[-1]),
        "pass_s": last["seconds"],
        "first_batch_s": last["first_batch_seconds"],
        "exit_steps": last["mean_exit_step"],
        "checked_lengths": run.obs.get("checked_lengths"),
        "probe_lengths": run.obs.get("probe_lengths"),
        "gap_stats": run.obs.get("gap_stats")}), flush=True)
    if dump:
        with open(dump, "a") as f:
            f.write(json.dumps({"seed": seed, "control": control or "none",
                                **run.hyp_gaps}) + "\n")


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
    p.add_argument("--dump", default=None)
    a = p.parse_args()
    from benchmark.drivers.decode_lm import DecodeLM, lm_scores
    from benchmark.harness import device, spec
    cell = spec.load_cell(a.workload, a.bench)
    dev = device.acquire(a.device, 1)
    control_seeds = set(map(int, (a.control_seeds or a.seeds).split(",")))
    controls = [c for c in a.controls.split(",") if c]
    for seed in map(int, a.seeds.split(",")):
        run = DecodeLM(cell, seed, dev)
        run.setup(warm=False)
        run.window(0)
        report(run, seed, "", lm_scores(run, cell.limits), a.dump)
        if seed not in control_seeds:
            controls_here = []
        elif "fp8" in controls:
            # the control scores this seed's hypotheses of the program
            report(run, seed, "fp8", lm_scores(run, cell.limits, "fp8"),
                   a.dump)
            controls_here = [c for c in controls if c != "fp8"]
        else:
            controls_here = controls
        for control in controls_here:
            take_out = plant(control, a.fault_start)
            try:
                run.window(0)
            finally:
                take_out()
            report(run, seed, control, lm_scores(run, cell.limits), a.dump)
        run.release()
        shutil.rmtree(run.tmp, ignore_errors=True)
        del run


if __name__ == "__main__":
    main()
