"""The weight bridge, init laws and checkpoints of the port, and the rule
that the port imports no JAX and nothing of mtn_tpu."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mtn_tpu_torch.config import ModelConfig
from mtn_tpu_torch.weights import (from_flax, init_params, load_checkpoint,
                                   load_model, param_shapes,
                                   save_checkpoint, to_flax)
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, jax_init_params,
                                one_thread, port_cfg)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def flax_params():
    rng = np.random.default_rng(0)
    jdb, _ = both_batches(host_fields(rng))
    cfg = tiny_model_cfg(30, (12, 8), diff_embed=True, diff_gen=True,
                         separate_his_embed=True)
    return cfg, jax_init_params(cfg, jdb)


def test_round_trip_is_bitwise(flax_params):
    cfg, params = flax_params
    back = dict(_leaves(to_flax(from_flax(params))))
    want = dict(_leaves(params))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_bf16_round_trip_is_bitwise():
    import ml_dtypes
    a = np.random.default_rng(1).standard_normal((4, 3)).astype(
        ml_dtypes.bfloat16)
    back = to_flax(from_flax({"m": {"kernel": a}}))["m"]["kernel"]
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))


def test_state_dict_keys_are_flax_paths(flax_params):
    """Every flax param maps onto one port parameter of the same shape."""
    cfg, params = flax_params
    flax_shapes = {k.replace("/", "."): v.shape for k, v in _leaves(params)}
    assert param_shapes(port_cfg(cfg)) == flax_shapes


def test_init_laws():
    cfg = ModelConfig(vocab_size=50, nb_blocks=1, d_model=16, d_ff=32,
                      att_h=2, ft_sizes=[12])
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    k = sd["decoder.layer_0.ff.w_1.kernel"]
    assert k.shape == (16, 32) and k.abs().max() <= (6 / 48) ** 0.5
    assert sd["decoder.layer_0.ff.w_1.bias"].abs().max() == 0
    assert torch.all(sd["decoder.norm.scale"] == 1)
    assert sd["embed_src.lut.embedding"].abs().max() <= (6 / 66) ** 0.5
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[n], again[n]) for n in sd)


def test_checkpoint_and_compute_dtype(tmp_path):
    cfg = ModelConfig(vocab_size=50, nb_blocks=1, d_model=16, d_ff=32,
                      att_h=2, ft_sizes=[12], dtype="bfloat16")
    sd = init_params(cfg, torch.Generator().manual_seed(1))
    prefix = str(tmp_path / "m")
    save_checkpoint(prefix, 2, sd, best=True)
    save_checkpoint(prefix, 3, sd, best=False)
    got, epoch = load_checkpoint(prefix, "best")
    assert epoch == 2 and load_checkpoint(prefix, "latest")[1] == 3
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    model = load_model(cfg, got, "cpu")
    # linear/embedding weights cast once to bf16; norms stay f32
    assert model.decoder.layer_0.ff.w_1.kernel.dtype == torch.bfloat16
    assert model.embed_src.lut.embedding.dtype == torch.bfloat16
    assert model.decoder.norm.scale.dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def test_port_imports_no_jax_and_nothing_of_mtn_tpu():
    code = (
        "import pkgutil, importlib, sys\n"
        "import mtn_tpu_torch\n"
        "for m in pkgutil.walk_packages(mtn_tpu_torch.__path__, "
        "'mtn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'flax', "
        "'orbax') or n.startswith(('jax.', 'flax.', 'orbax.')) "
        "or n == 'mtn_tpu' or n.startswith('mtn_tpu.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules "
        "if n.startswith('mtn_tpu_torch')))"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 15
    for name in ("cli.train", "train.trainer", "train.loss",
                 "train.schedule", "data.pipeline", "utils.checkpoint",
                 "utils.logging", "cli.rank", "cli.evaluate",
                 "evalmetrics.meteor", "evalmetrics.retrieval",
                 "data.native_loader", "data.feature_cache",
                 "utils.profiling", "utils.average", "ops.matmul",
                 "utils.aot", "decode.steps", "parallel.mesh",
                 "parallel.multihost", "parallel.sharding",
                 "parallel.collectives", "serve", "serve_http",
                 "utils.migrate"):
        assert f"mtn_tpu_torch.{name}" in loaded, name


def _of_jax_package(name) -> bool:
    return isinstance(name, str) and (name == "mtn_tpu"
                                      or name.startswith("mtn_tpu."))


def jax_package_uses(source: str):
    """(line, what) of every use of the JAX package in ``source``: an
    ``import``/``from`` of ``mtn_tpu``, at any depth (inside functions
    too), ``import_module``/``__import__`` of it, and ``-m mtn_tpu.``,
    whether in one string or as a ``"-m"`` element before it."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if _of_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _of_jax_package(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    _of_jax_package(node.args[0].value):
                found.append((node.lineno, node.args[0].value))
        elif isinstance(node, (ast.List, ast.Tuple)):
            items = [e.value if isinstance(e, ast.Constant) else None
                     for e in node.elts]
            found += [(node.lineno, f"-m {b}") for a, b in
                      zip(items, items[1:]) if a == "-m"
                      and _of_jax_package(b)]
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and "-m mtn_tpu." in node.value:
            found.append((node.lineno, node.value.strip()[:60]))
    return found


def test_import_guard_finds_every_kind_of_use():
    src = ("import mtn_tpu\nimport os, mtn_tpu.config as c\n"
           "from mtn_tpu.data import load\n"
           "def f():\n    from mtn_tpu.cli import rank\n"
           "    importlib.import_module('mtn_tpu.serve')\n"
           "    subprocess.run([sys.executable, '-m',\n"
           "                    'mtn_tpu.cli.evaluate'])\n"
           "    os.system('python -m mtn_tpu.cli.evaluate score a b')\n"
           "import mtn_tpu_torch.cli\nfrom mtn_tpu_torch import weights\n"
           "from . import beam\nx = ['-m', 'mtn_tpu_torch.cli.rank']\n")
    assert [line for line, _ in jax_package_uses(src)] == \
        [1, 2, 3, 5, 6, 7, 9]


def test_port_and_chip_smoke_never_use_the_jax_package():
    """Every .py of the port, ``chip_smoke.py`` and the port's readiness
    check, parsed: no use of ``mtn_tpu`` anywhere, lazy imports inside
    functions included."""
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "check_dstc7_data_torch.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mtn_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 40
    bad = {}
    for path in paths:
        with open(path) as f:
            uses = jax_package_uses(f.read())
        if uses:
            bad[os.path.relpath(path, REPO)] = uses
    assert not bad, bad


def shell_jax_package_uses(text: str):
    """(line, text) of every line of a shell script that could run the JAX
    package or its drivers: a ``mtn_tpu.`` module, ``train.py`` or
    ``generate.py``. Comments are skipped."""
    found = []
    for n, line in enumerate(text.splitlines(), 1):
        code = re.sub(r"(^|\s)#.*$", "", line)
        if re.search(r"\bmtn_tpu\.|\b(train|generate)\.py\b", code):
            found.append((n, line.strip()))
    return found


def test_shell_guard_finds_every_kind_of_use():
    src = ("python train.py --a 1\n"
           "  python generate.py \\\n"
           "python -m mtn_tpu.cli.evaluate score a b\n"
           "x=$(python -m mtn_tpu.data.features)\n"
           "# python train.py in a comment\n"
           "python -m mtn_tpu_torch.cli.train --x 1  # not generate.py\n"
           "python -m mtn_tpu_torch.cli.evaluate annotation a b\n")
    assert [n for n, _ in shell_jax_package_uses(src)] == [1, 2, 3, 4]


def test_run_torch_sh_never_calls_the_jax_package():
    """``run_torch.sh``: no stage runs ``mtn_tpu``, ``train.py`` or
    ``generate.py``; every stage runs the port's CLIs."""
    with open(os.path.join(REPO, "run_torch.sh")) as f:
        text = f.read()
    assert not shell_jax_package_uses(text)
    for cli in ("train", "generate", "evaluate"):
        assert f"python -m mtn_tpu_torch.cli.{cli} " in text
