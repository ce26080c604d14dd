"""The comparison that decides ``correct``: the reference against the
port at a tiny size, the control (the reference in float8 in the
program's place) and faults planted under the timed path, each of which
has to come out as not correct."""

import contextlib
import io
import json
import os

import pytest
import torch

from benchmark.harness import spec
from conftest import ROOT, TINY


def main(*extra, seed=11, workload="tiny-decode"):
    run = spec.load_module(os.path.join(ROOT, "benchmark", "run.py"),
                           "benchmark_run")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0", "--device", "cpu", "--bench", TINY,
                       *extra])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_reference_spec_is_the_ports():
    from benchmark.drivers.decode import model_config, reference_config
    from benchmark.reference.mtn_ref import param_spec
    from mtn_tpu_torch.weights import param_shapes
    cfg = spec.load_cell("tiny-decode", TINY).config
    want = param_shapes(model_config(cfg))
    got = param_spec(reference_config(cfg))
    assert list(got) == list(want)
    assert all(tuple(got[k]) == tuple(want[k]) for k in want)


@pytest.mark.parametrize("workload,seed", [
    ("tiny-decode", 11), ("tiny-decode", 12), ("tiny-decode", 2 ** 32 + 7),
    ("tiny-text-decode", 11)])
def test_program_is_correct(workload, seed):
    line = main(seed=seed, workload=workload)
    assert line["correct"] is True
    assert line["checks"]["score_gap_per_token"]["value"] < 1e-5


@pytest.mark.parametrize("workload,seed", [
    ("tiny-decode", 11), ("tiny-decode", 12), ("tiny-decode", 13),
    ("tiny-text-decode", 11)])
def test_control_is_not_correct(workload, seed):
    line = main("--control", "fp8", seed=seed, workload=workload)
    assert line["correct"] is False
    gap = line["checks"]["score_gap_per_token"]
    assert gap["value"] > 3 * gap["limit"]


@pytest.mark.parametrize("fault,start", [
    ("kv_unwritten", 0), ("kv_unwritten", 5), ("token_altered", 0),
    ("token_altered", 5), ("half_left_out", 0)])
def test_faults_are_not_correct(fault, start):
    """Each fault, also from decoder position 5 on (the tiny cell's
    answers run to about 8 words)."""
    from benchmark.tools import faults
    take_out = faults.plant(fault, start)
    try:
        assert main()["correct"] is False
    finally:
        take_out()


@pytest.mark.card
@pytest.mark.parametrize("workload", ["decode-av-beam5",
                                      "decode-text-beam5"])
def test_cell_on_the_card(card, workload):
    """A short window of a real cell on the card (about 90 s each)."""
    run = spec.load_module(os.path.join(ROOT, "benchmark", "run.py"),
                           "benchmark_run")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", "5",
                       "--seconds", "1", "--trace", "1"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    torch.cuda.empty_cache()
