#!/usr/bin/env python
"""Readiness check of a DSTC7-AVSD download for ``run_torch.sh``, the
stage driver of the PyTorch/CUDA port (``mtn_tpu_torch``).

The same checks as ``scripts/check_dstc7_data.py`` (which serves
``run.sh``), on the port's own header reader
(``mtn_tpu_torch.data.features.get_npy_shape``), so it needs nothing of
the JAX package. It tells a user who has the download whether
``run_torch.sh`` stages 1-4 will work before they spend hours training:

- the four dialogue JSONs exist, parse, and have the expected structure
  (the file names of run_torch.sh's variables);
- the undisclosed eval file is found under either spelling,
  ``lbl_undisclosedonly_...`` (the variables) or ``lbl_undiscloseonly_...``
  (the download); stage 4 accepts both;
- every sampled video has a feature file per stream in the train
  (``data/<FeaType>/<ImageID>.npy``) and test
  (``data/<FeaType>_testset/...``) layouts, with a uniform feature dim,
  a loadable dtype, and a 2-D ``(T, D)`` or 3-D ``(T, R, D)`` shape (3-D
  streams flatten regions into frames);
- ``data/stopwords.txt`` exists for stage-4 scoring.

Exit 0 and the exact run_torch.sh commands if everything passes; exit 1
with per-item FAIL lines otherwise.

    python scripts/check_dstc7_data_torch.py --data-root data

Tested against the synthetic corpus in
tests/test_torch_run_sh.py::test_check_dstc7_data_torch_script.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mtn_tpu_torch.data.features import get_npy_shape  # noqa: E402

REQUIRED_SETS = {
    "train": "train_set4DSTC7-AVSD.json",
    "valid": "valid_set4DSTC7-AVSD.json",
    "test": "test_set4DSTC7-AVSD.json",
    "labeled test": "lbl_test_set4DSTC7-AVSD.json",
}
EVAL_SPELLINGS = ("lbl_undisclosedonly_test_set4DSTC7-AVSD.json",
                  "lbl_undiscloseonly_test_set4DSTC7-AVSD.json")

_ok = True


def report(ok: bool, msg: str, fatal: bool = True):
    global _ok
    print(("  OK   " if ok else ("  FAIL " if fatal else "  WARN ")) + msg)
    if not ok and fatal:
        _ok = False
    return ok


def check_dialog_json(path: str, want_undisclosed: bool):
    """Parse one dialogue file; returns its unique image_ids (or [])."""
    name = os.path.basename(path)
    if not os.path.exists(path):
        report(False, f"{name}: missing")
        return []
    try:
        with open(path) as f:
            data = json.load(f)
        dialogs = data["dialogs"]
        vids = []
        seen = set()
        n_turns = 0
        n_undisc = 0
        for d in dialogs:
            vid = d["image_id"]
            if vid not in seen:
                seen.add(vid)
                vids.append(vid)
            for t in d["dialog"]:
                t["question"], t["answer"]  # structure check
                n_turns += 1
                if "__UNDISCLOSED__" in t["answer"]:
                    n_undisc += 1
    except (KeyError, TypeError, ValueError) as e:
        report(False, f"{name}: unexpected structure ({e!r})")
        return []
    report(True, f"{name}: {len(dialogs)} dialogs, {n_turns} turns, "
                 f"{len(vids)} videos")
    if want_undisclosed:
        report(n_undisc > 0,
               f"{name}: {n_undisc} __UNDISCLOSED__ answers "
               "(stage 3 replaces these)", fatal=False)
    return vids


def check_features(data_root: str, fea_types, template: str, vids,
                   split: str, sample: int):
    rng = random.Random(0)
    picks = vids if len(vids) <= sample else rng.sample(vids, sample)
    for ft in fea_types:
        base = os.path.join(data_root, template.replace("<FeaType>", ft))
        dims, missing, bad = set(), [], []
        three_d = False
        for vid in picks:
            p = base.replace("<ImageID>", str(vid))
            if not os.path.exists(p):
                alt = os.path.splitext(p)[0] + ".pkl"
                if os.path.exists(alt):
                    p = alt
                else:
                    missing.append(p)
                    continue
            try:
                shape = get_npy_shape(p)
            except Exception as e:
                bad.append(f"{p}: unreadable header ({e!r})")
                continue
            if len(shape) == 2:
                dims.add(shape[-1])
            elif len(shape) == 3:
                dims.add(shape[-1])
                three_d = True
            else:
                bad.append(f"{p}: {len(shape)}-D shape {shape} "
                           "(only 2-D/3-D supported)")
        stream = f"{split} stream {ft!r}"
        if missing:
            report(False, f"{stream}: {len(missing)}/{len(picks)} sampled "
                          f"feature files missing (first: {missing[0]})")
            continue
        if bad:
            report(False, f"{stream}: {bad[0]}")
            continue
        if len(dims) != 1:
            report(False, f"{stream}: inconsistent feature dims {sorted(dims)}")
            continue
        note = " (3-D per-frame regions: flattened into the frame axis)" \
            if three_d else ""
        report(True, f"{stream}: {len(picks)} sampled files, "
                     f"dim {dims.pop()}{note}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--fea-types", default="i3d_rgb vggish",
                    help="space-separated streams the run will use")
    ap.add_argument("--fea-file", default="<FeaType>/<ImageID>.npy",
                    help="train/valid feature path template (run_torch.sh's "
                         "fea_file)")
    ap.add_argument("--sample", type=int, default=20,
                    help="videos sampled per split for feature checks")
    args = ap.parse_args(argv)
    global _ok
    _ok = True  # main() is re-entrant (tests call it repeatedly)
    root = args.data_root
    fea_types = args.fea_types.split()

    print(f"Checking DSTC7-AVSD layout under {root}/ "
          f"for streams {fea_types} ...")

    vids = {}
    for split, fname in REQUIRED_SETS.items():
        vids[split] = check_dialog_json(
            os.path.join(root, fname),
            want_undisclosed=(split == "test"))

    found = [s for s in EVAL_SPELLINGS
             if os.path.exists(os.path.join(root, s))]
    report(bool(found),
           f"undisclosed eval file: {found[0] if found else 'missing'}"
           + ("" if len(found) != 1 else
              " (either spelling works: stage 4 accepts both)"))

    if vids.get("train"):
        check_features(root, fea_types, args.fea_file, vids["train"],
                       "train", args.sample)
    if vids.get("valid"):
        check_features(root, fea_types, args.fea_file, vids["valid"],
                       "valid", args.sample)
    if vids.get("test"):
        test_tmpl = args.fea_file.replace("<FeaType>", "<FeaType>_testset")
        check_features(root, fea_types, test_tmpl, vids["test"],
                       "test", args.sample)

    report(os.path.exists(os.path.join(root, "stopwords.txt")),
           "stopwords.txt (stage-4 scoring filter)",
           fatal=False)

    names = "+".join(fea_types)
    if _ok:
        print("\nAll required checks passed. Paper-parity run on the "
              "port (reference defaults; add --device cpu without a GPU):")
        print(f"  bash run_torch.sh 2 \"{args.fea_types}\" {names} 20 9660 "
              "0.2")
        print("then compare exps/*/result_*.eval against BASELINE.md. "
              "Stages 3/4 alone:")
        print(f"  bash run_torch.sh 3 \"{args.fea_types}\" {names} 20 9660 "
              "0.2")
        return 0
    print("\nFAIL: fix the items above before running the pipeline.")
    return 1


if __name__ == "__main__":
    sys.exit(main())
