"""One run of a tiny cell on the CPU, end to end, in a new process."""

import json
import os
import subprocess
import sys

from conftest import ROOT, TINY

RUN = os.path.join(ROOT, "benchmark", "run.py")
CONTRACT = ("correct", "attempted", "failed", "metrics", "device")


def run(*extra, seed="3000000123"):
    return subprocess.run(
        [sys.executable, RUN, "--workload", "tiny-decode", "--seed", seed,
         "--seconds", "0.5", "--bench", TINY, *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_cpu_run_prints_one_contract_line():
    out = run("--device", "cpu", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == list(CONTRACT)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % 12 == 0
    assert set(line["metrics"]) == {"setup_s", "decode_responses_per_s"}
    assert line["device"]["platform"] == "cpu"
    # the numbers compared are the last lines on stderr too
    tail = out.stderr.strip().splitlines()[-2:]
    assert [t.split(":")[0] for t in tail] == [
        "check score_gap_per_token", "check unscored"]


def test_cpu_traced_run_reads_the_per_layer_metrics():
    out = run("--device", "cpu", "--trace", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    # the device readings need a card: on the CPU they find nothing
    assert set(line["metrics"]) == {"host_batch_ms.decode",
                                    "decode_first_batch_s",
                                    "decode_exit_steps", "mfu.decode"}
    assert line["metrics"]["decode_exit_steps"]["value"] > 0


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return
    out = run("--trace", "0")
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
