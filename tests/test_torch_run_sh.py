"""``run_torch.sh``, run.sh's stage driver on the port, on the CPU.

The static checks parse both drivers: every variable run.sh defines before
its options are parsed keeps its default in ``run_torch.sh``, which adds
only ``device=cuda``; every flag run.sh passes to ``train.py``,
``generate.py`` and ``mtn_tpu.cli.evaluate`` reaches the port's
counterpart with the same value expression, plus ``--device ${device}``
to training and generation.

One module fixture runs ``bash run_torch.sh 2`` (stages 2-4) from the
repo root on the tiny corpus of ``tests/fixtures.py`` at the verify
skill's tiny widths with ``--device cpu``, its paths given as overrides.
The tests then read its artifacts, decode its checkpoint directly with
``python -m mtn_tpu_torch.cli.generate`` (the same bytes), run stage 4 of
both drivers on one result JSON (the same score block) and check the
port's readiness script, ``scripts/check_dstc7_data_torch.py``.
"""

import csv
import importlib.util
import json
import os
import re
import shlex
import shutil
import subprocess
import sys

import pytest

from tests.fixtures import write_tiny_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSITIONALS = ["i3d_rgb vggish", "i3d+vggish", "1", "20", "0.1"]
TINY = ["--nb_blocks", "1", "--d_model", "16", "--d_ff", "32", "--att_h",
        "2", "--batch_size", "4", "--max_length", "64", "--length_bucket",
        "8", "--feature_bucket", "4", "--turn_batch", "4",
        "--report_interval", "2", "--dtype", "float32"]
RESULT = "result_test_set_b5_p1.0_beam_search_undisclosed1.json"
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
           "CIDEr")
# run.sh's command -> the port's
COMMANDS = {"python train.py": "python -m mtn_tpu_torch.cli.train",
            "python generate.py": "python -m mtn_tpu_torch.cli.generate",
            "python -m mtn_tpu.cli.evaluate annotation":
                "python -m mtn_tpu_torch.cli.evaluate annotation",
            "python -m mtn_tpu.cli.evaluate hypotheses":
                "python -m mtn_tpu_torch.cli.evaluate hypotheses",
            "python -m mtn_tpu.cli.evaluate score":
                "python -m mtn_tpu_torch.cli.evaluate score"}


def _script(name):
    with open(os.path.join(REPO, name)) as f:
        return f.read()


def _variables(text):
    """``{name: value}`` of the plain assignments before the options are
    parsed (``. utils/parse_options.sh``)."""
    head = text[:text.index(". utils/parse_options.sh")]
    out = {}
    for line in head.splitlines():
        m = re.match(r"^\s*([a-z_]+)=(.*?)\s*(#.*)?$", line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _command(text, command):
    """The tokens after ``command`` (its continuation lines joined), for
    the one line of ``text`` that starts it."""
    joined = text.replace("\\\n", " ")
    lines = [ln.strip() for ln in joined.splitlines()
             if ln.strip().startswith(command + " ")]
    assert len(lines) == 1, (command, lines)
    return shlex.split(lines[0][len(command):], posix=False)


def _flags(tokens):
    """``{flag: value}`` of ``--flag value`` pairs; the other tokens (the
    positionals) in order under None."""
    out, rest, i = {}, [], 0
    while i < len(tokens):
        if tokens[i].startswith("-") and i + 1 < len(tokens) and \
                not tokens[i + 1].startswith("-"):
            out[tokens[i]] = tokens[i + 1]
            i += 2
        else:
            rest.append(tokens[i])
            i += 1
    out[None] = rest
    return out


def test_run_torch_sh_keeps_every_run_sh_variable():
    run_sh, port = _variables(_script("run.sh")), _variables(
        _script("run_torch.sh"))
    assert len(run_sh) >= 60
    assert {k: port.get(k) for k in run_sh} == run_sh
    assert set(port) - set(run_sh) == {"device"}
    assert port["device"] == "cuda"


@pytest.mark.parametrize("command", list(COMMANDS))
def test_run_torch_sh_passes_every_run_sh_flag(command):
    want = _flags(_command(_script("run.sh"), command))
    got = _flags(_command(_script("run_torch.sh"), COMMANDS[command]))
    if "evaluate" not in command:
        assert got.pop("--device") == "${device}"
    assert got == want


def _corpus(root):
    """The tiny corpus with run.sh's stage-3/4 layout: feature directories
    ``<FeaType>_testset`` and the undisclosed-only labeled set (each
    dialog's last turn)."""
    c = write_tiny_corpus(root, n_dialogs=8, n_turns=3)
    with open(c.lbl_test_set) as f:
        lbl = json.load(f)
    for d in lbl["dialogs"]:
        d["dialog"] = d["dialog"][-1:]
    eval_set = os.path.join(root, "lbl_undisclosedonly_test_set.json")
    with open(eval_set, "w") as f:
        json.dump(lbl, f)
    for ft in c.fea_types:
        os.symlink(os.path.join(root, ft), os.path.join(root, f"{ft}_testset"))
    return c, eval_set


def _paths(c, eval_set, expdir):
    return ["--train_set", c.train_set, "--valid_set", c.valid_set,
            "--test_set", c.test_set, "--labeled_test", c.lbl_test_set,
            "--eval_set", eval_set, "--fea_dir", str(c.root),
            "--expdir", str(expdir)]


def _run(script, stage, *options, jax=False):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if jax:   # run.sh's stage 4 runs mtn_tpu's evaluate CLI
        env.update(PYTHONPATH="", JAX_PLATFORMS="cpu")
    return subprocess.run(["bash", script, str(stage), *POSITIONALS,
                           *options], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


def _summary(stdout):
    """The metric lines between run.sh's summary markers."""
    block = stdout.split("--- summary ---\n", 1)[1].split("-----")[0]
    return block.splitlines()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_torch")
    c, eval_set = _corpus(root / "data")
    expdir = root / "exp"
    proc = _run("run_torch.sh", 2, "--device", "cpu", *TINY,
                *_paths(c, eval_set, expdir))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(corpus=c, eval_set=eval_set, expdir=expdir, root=root,
                stdout=proc.stdout, stderr=proc.stderr)


def test_stage_2_writes_the_logs_the_conf_and_the_best_checkpoint(pipeline):
    exp = pipeline["expdir"]
    with open(exp / "mtn_train.csv") as f:
        assert next(csv.reader(f)) == ["epoch", "step", "loss",
                                       "tokens_per_sec"]
    with open(exp / "mtn_trace.csv") as f:
        assert len(f.read().splitlines()) >= 3   # header, train, val
    with open(exp / "mtn.conf.json") as f:
        conf = json.load(f)
    # the overrides reached the model, the data and the trainer
    assert {k: conf["model"][k] for k in ("nb_blocks", "d_model", "d_ff",
                                          "att_h", "dtype")} == \
        {"nb_blocks": 1, "d_model": 16, "d_ff": 32, "att_h": 2,
         "dtype": "float32"}
    assert conf["model"]["dropout"] == 0.1
    assert conf["data"]["batch_size"] == 4
    assert conf["data"]["length_bucket"] == 8
    assert conf["train"]["warmup_steps"] == 20
    with open(exp / "mtn_torch" / "meta.json") as f:
        assert json.load(f)["best_epoch"] == 1
    assert "kernel launches: train " in pipeline["stderr"]


def test_stage_3_replaces_every_undisclosed_answer(pipeline):
    with open(pipeline["expdir"] / RESULT) as f:
        result = json.load(f)
    answers = [qa["answer"] for d in result["dialogs"] for qa in d["dialog"]]
    assert len(answers) == 3
    assert "__UNDISCLOSED__" not in answers


def test_stage_4_prints_the_metric_block(pipeline):
    block = _summary(pipeline["stdout"])
    assert [line.split(":")[0] for line in block] == list(METRICS)
    exp = pipeline["expdir"]
    stem = RESULT[:-len(".json")]
    with open(exp / f"{stem}_ref.json") as f:
        refs = json.load(f)["annotations"]
    with open(exp / f"{stem}_hyp.json") as f:
        assert len(json.load(f)) == len(refs) == 3
    with open(exp / f"{stem}.eval") as f:
        assert [ln for ln in f.read().splitlines() if ln.split(":")[0]
                in METRICS] == block


def test_stage_3_bytes_equal_a_direct_generate_run(pipeline):
    c, exp = pipeline["corpus"], pipeline["expdir"]
    out = pipeline["root"] / "direct.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mtn_tpu_torch.cli.generate",
         "--test-path", f"{c.root}/<FeaType>_testset/<ImageID>.npy",
         "--test-set", c.test_set, "--model-conf", f"{exp}/mtn.conf.json",
         "--model", f"{exp}/mtn_best", "--beam", "5", "--penalty", "1.0",
         "--nbest", "5", "--output", str(out), "--decode-style",
         "beam_search", "--undisclosed-only", "1", "--labeled-test",
         c.lbl_test_set, "--turn-batch", "4", "--dtype", "float32",
         "--device", "cpu"], cwd=REPO, env=dict(os.environ,
                                                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert out.read_bytes() == (exp / RESULT).read_bytes()


def test_stage_4_scores_as_run_sh_scores(pipeline):
    """One result JSON whose answers overlap the references in part (so
    the scores are not all 0), scored by stage 4 of each driver."""
    c, eval_set = pipeline["corpus"], pipeline["eval_set"]
    with open(eval_set) as f:
        result = json.load(f)
    for i, d in enumerate(result["dialogs"]):
        words = d["dialog"][-1]["answer"].split()
        d["dialog"][-1]["answer"] = " ".join(words[:-1] + ["the"] * (i % 2))
    blocks = {}
    for script in ("run.sh", "run_torch.sh"):
        exp = pipeline["root"] / f"stage4_{script}"
        exp.mkdir()
        with open(exp / RESULT, "w") as f:
            json.dump(result, f)
        proc = _run(script, 4, *_paths(c, eval_set, exp),
                    jax=script == "run.sh")
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
        blocks[script] = _summary(proc.stdout)
    assert blocks["run_torch.sh"] == blocks["run.sh"]
    assert len(blocks["run.sh"]) == 7
    assert any(float(line.split()[1]) > 0 for line in blocks["run.sh"])


def test_an_unknown_option_exits_1():
    proc = _run("run_torch.sh", 4, "--no_such_flag", "5")
    assert proc.returncode == 1
    assert "invalid option --no_such_flag" in proc.stderr


def test_stage_1_warns_of_missing_data(tmp_path):
    """Stage 1 downloads nothing: it names the built-in metrics and warns
    of each missing set; stage 2 then fails on the missing data."""
    missing = str(tmp_path / "nowhere.json")
    proc = _run("run_torch.sh", 1, "--device", "cpu", "--train_set",
                missing, "--valid_set", missing, "--expdir",
                str(tmp_path / "exp"))
    assert "evaluation metrics: built-in (mtn_tpu_torch.evalmetrics)" in \
        proc.stdout
    assert proc.stdout.count(f"WARNING: missing data file {missing}") == 2
    assert proc.returncode != 0


def test_check_dstc7_data_torch_script(tmp_path, capsys):
    """Passes on a corpus laid out like the real DSTC7 download (with the
    download's 'lbl_undiscloseonly_' spelling) and prints run_torch.sh
    commands; exits 1 when a feature file or a dialogue set is missing."""
    spec = importlib.util.spec_from_file_location(
        "check_dstc7_data_torch",
        os.path.join(REPO, "scripts", "check_dstc7_data_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    root = tmp_path / "data"
    c = write_tiny_corpus(root, n_dialogs=4, n_turns=2)
    os.rename(c.train_set, root / "train_set4DSTC7-AVSD.json")
    os.rename(c.valid_set, root / "valid_set4DSTC7-AVSD.json")
    os.rename(c.test_set, root / "test_set4DSTC7-AVSD.json")
    os.rename(c.lbl_test_set, root / "lbl_test_set4DSTC7-AVSD.json")
    shutil.copy(root / "lbl_test_set4DSTC7-AVSD.json",
                root / "lbl_undiscloseonly_test_set4DSTC7-AVSD.json")
    (root / "stopwords.txt").write_text("uh\n")
    for ft in c.fea_types:
        os.symlink(root / ft, root / f"{ft}_testset")

    argv = ["--data-root", str(root), "--fea-types", "i3d_rgb vggish"]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "bash run_torch.sh 2 \"i3d_rgb vggish\" i3d_rgb+vggish" in out
    assert "run.sh 2" not in out.replace("run_torch.sh 2", "")
    assert "lbl_undiscloseonly_" in out

    next((root / "i3d_rgb").glob("*.npy")).unlink()
    assert mod.main(argv) == 1
    assert "FAIL" in capsys.readouterr().out

    (root / "valid_set4DSTC7-AVSD.json").unlink()
    assert mod.main(argv) == 1
