"""The head's scale of a language-model decode cell against the lengths
of the beam's answers (``tools/calibrate.py``'s measure, for
``drivers/decode_lm.py``).

    python3 benchmark/tools/calibrate_lm.py \\
        --workload decode-kimivl-avsd-beam5 --seed 11 --scales 4,64 \\
        --bisect 6

The cell's test split and its weights are made once; for each scale
only ``lm_head`` is made anew (its own generator, times the scale) and
copied into the model in place, and one whole pass runs. Each prints one
JSON line: the pass's mean exit step and the words of each turn's best
answer (median, quartiles, mean) and of its longest n-best hypothesis.
With ``--bisect n`` the scale is then bisected ``n`` times, geometrically,
between the first two ``--scales`` towards the mean words of the split's
own answers; the last line names the scale tried whose mean came
nearest."""

import argparse
import json
import math
import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--scales", required=True)
    p.add_argument("--bisect", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=None)
    a = p.parse_args()
    import torch
    from benchmark.drivers.decode_lm import make_weights
    from benchmark.harness import device, spec, traffic
    cell = spec.load_cell(a.workload, a.bench)
    dev = device.acquire(a.device, 1)
    run = spec.driver_module(cell).Decode(cell, a.seed, dev)
    run.setup(warm=False)
    laws = dict(cell.config["weights"])
    head = run.model.lm_head.weight
    split = traffic.make_dialogs(dict(run.tr, undisclosed_only=False),
                                 a.seed, 8, {})
    target = statistics.mean(len(qa["answer"].split())
                             for d in split.dialogs for qa in d["dialog"])
    print(json.dumps({"target_mean_answer_words": target}), flush=True)
    tried = {}

    def mean_words(scale):
        laws["generator_scale"] = scale
        new = make_weights(run.cfg, dev, head.dtype, laws,
                           only={"lm_head.weight"})["lm_head.weight"]
        with torch.no_grad():
            head.copy_(new)
        del new
        stats, nbest = run.one_pass()
        best = [len(h[0][0].split()) for h in nbest.values()]
        longest = [max(len(w.split()) for w, _ in h) for h in nbest.values()]
        q = statistics.quantiles(best, n=4)
        print(json.dumps({"seed": a.seed, "scale": scale,
                          "mean_exit_step": stats["mean_exit_step"],
                          "best_words_median": q[1],
                          "best_words_quartiles": [q[0], q[2]],
                          "best_words_mean": statistics.mean(best),
                          "longest_words_mean": statistics.mean(longest)}),
              flush=True)
        tried[scale] = statistics.mean(best)
        return tried[scale]
    scales = [float(s) for s in a.scales.split(",")]
    for s in scales:
        mean_words(s)
    lo, hi = scales[:2] if len(scales) > 1 else (scales[0], scales[0])
    for _ in range(a.bisect):
        mid = math.sqrt(lo * hi)
        lo, hi = (mid, hi) if mean_words(mid) < target else (lo, mid)
    print(json.dumps({"chosen": min(tried, key=lambda s: (
        abs(tried[s] - target), s))}), flush=True)
    shutil.rmtree(run.tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
