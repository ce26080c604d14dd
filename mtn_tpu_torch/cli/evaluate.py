"""Scoring entry point (``mtn_tpu/cli/evaluate.py``; run.sh stage 4).

    python -m mtn_tpu_torch.cli.evaluate annotation --last lbl.json ref.json
    python -m mtn_tpu_torch.cli.evaluate hypotheses --last result.json hyp.json
    python -m mtn_tpu_torch.cli.evaluate score ref.json hyp.json

The same three subcommands as the JAX CLI, on the port's copy of
``evalmetrics``; ``score`` prints the metric block in the reference format
(``Bleu_1: ...`` .. ``CIDEr: ...``) that run.sh's awk reads.
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description="DSTC7 evaluation tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    ann = sub.add_parser("annotation", help="dialog JSON -> COCO references")
    ann.add_argument("--stopwords", "-s", default="", type=str)
    ann.add_argument("--last", "-l", action="store_true")
    ann.add_argument("dialog_file")
    ann.add_argument("output_file")

    hyp = sub.add_parser("hypotheses", help="result JSON -> COCO hypotheses")
    hyp.add_argument("--stopwords", "-s", default="", type=str)
    hyp.add_argument("--last", "-l", action="store_true")
    hyp.add_argument("result_file")
    hyp.add_argument("hypout_file")

    sc = sub.add_parser("score", help="score references vs hypotheses")
    sc.add_argument("--json", default="", type=str,
                    help="also write the scores as JSON to this path "
                         "(the printed block stays reference-format for "
                         "run.sh's awk extract)")
    sc.add_argument("reference")
    sc.add_argument("hypothesis")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mtn_tpu_torch.evalmetrics import (build_annotation, build_hypotheses,
                                           score_files)
    if args.cmd == "annotation":
        with open(args.dialog_file) as f:
            data = json.load(f)
        out = build_annotation(data, stopwords=args.stopwords or None,
                               last_only=args.last)
        with open(args.output_file, "w") as f:
            json.dump(out, f, indent=4)
    elif args.cmd == "hypotheses":
        with open(args.result_file) as f:
            data = json.load(f)
        out = build_hypotheses(data, stopwords=args.stopwords or None,
                               last_only=args.last)
        with open(args.hypout_file, "w") as f:
            json.dump(out, f, indent=4)
    elif args.cmd == "score":
        scores = score_files(args.reference, args.hypothesis,
                             print_scores=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(scores, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
