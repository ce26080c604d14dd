"""The port's copy of ``evalmetrics`` and its ``cli.evaluate`` against
mtn_tpu's: every metric equal exactly (``==``) on the goldens' inputs and
a seeded random corpus, and the three subcommands writing byte-identical
files."""

import json

import numpy as np
import pytest

from mtn_tpu.cli import evaluate as jax_evaluate
from mtn_tpu.evalmetrics import bleu as j_bleu
from mtn_tpu.evalmetrics import cider as j_cider
from mtn_tpu.evalmetrics import meteor as j_meteor
from mtn_tpu.evalmetrics import retrieval as j_retrieval
from mtn_tpu.evalmetrics import rouge as j_rouge
from mtn_tpu.evalmetrics import scorer as j_scorer
from mtn_tpu.evalmetrics import stem as j_stem
from mtn_tpu.evalmetrics import tokenizer as j_tokenizer
from mtn_tpu_torch.cli import evaluate as t_evaluate
from mtn_tpu_torch.evalmetrics import bleu as t_bleu
from mtn_tpu_torch.evalmetrics import cider as t_cider
from mtn_tpu_torch.evalmetrics import meteor as t_meteor
from mtn_tpu_torch.evalmetrics import retrieval as t_retrieval
from mtn_tpu_torch.evalmetrics import rouge as t_rouge
from mtn_tpu_torch.evalmetrics import scorer as t_scorer
from mtn_tpu_torch.evalmetrics import stem as t_stem
from mtn_tpu_torch.evalmetrics import tokenizer as t_tokenizer
from tests.fixtures import WORDS, make_dialog_json
from tests.test_metric_goldens import PTB_GOLDENS

# words whose stems, inflections and function-word weights the metrics see
EXTRA = ("walking walked walks dogs opened opening readings happily "
         "the of to relational conditional hopeful").split()
RAW = [raw for raw, _ in PTB_GOLDENS] + [
    "The &quot;dogs&quot; aren't walking -- they're sitting.",
    "It's 3:45 p.m. and the man (who?) reads 2,000 books!"]


def _corpus(seed=11, n=40):
    """{id: [reference, ...]} and {id: [hypothesis]} of seeded word
    strings, some sharing words, some empty of overlap."""
    rng = np.random.default_rng(seed)
    words = list(WORDS) + EXTRA
    say = lambda: " ".join(rng.choice(words, int(rng.integers(1, 12))))
    refs = {f"v{i}": [say() for _ in range(int(rng.integers(1, 4)))]
            for i in range(n)}
    hyps = {k: [say() if i % 5 else r[0]] for i, (k, r) in
            enumerate(refs.items())}
    return refs, hyps


def _goldens_corpus():
    """Tokenized references and hypotheses from the goldens' raw text."""
    toks = [" ".join(j_tokenizer.tokenize(r)) for r in RAW]
    refs = {f"g{i}": [t, toks[(i + 1) % len(toks)]]
            for i, t in enumerate(toks)}
    hyps = {f"g{i}": [toks[(i + 2) % len(toks)] if i % 3 else t]
            for i, t in enumerate(toks)}
    return refs, hyps


def _ranks(seed=3):
    rng = np.random.default_rng(seed)
    scores = [list(rng.integers(-4, 4, size=int(rng.integers(1, 12)))
                   .astype(float)) for _ in range(30)]
    return [(s, int(rng.integers(0, len(s)))) for s in scores]


CASES = {
    "bleu": lambda m, c: m["bleu"].corpus_bleu(*c),
    "meteor": lambda m, c: m["meteor"].meteor(*c),
    "meteor_2005": lambda m, c: m["meteor"].meteor_2005(*c),
    "meteor_normalize": lambda m, c: [m["meteor"].normalize(r) for r in RAW],
    "rouge_l": lambda m, c: m["rouge"].rouge_l(*c),
    "cider": lambda m, c: m["cider"].cider(*c),
    "ptb_tokenizer": lambda m, c: ([m["tokenizer"].tokenize(r) for r in RAW],
                                   m["tokenizer"].tokenize_corpus(c[0])),
    "porter_stem": lambda m, c: [m["stem"].porter_stem(w) for w in
                                 sorted({w for s in c[0].values() for r in s
                                         for w in r.split()})],
    "rank_of": lambda m, c: [m["retrieval"].rank_of(s, g)
                             for s, g in _ranks()],
    "retrieval_metrics": lambda m, c: m["retrieval"].retrieval_metrics(
        [m["retrieval"].rank_of(s, g) for s, g in _ranks()]),
    "score_pairs": lambda m, c: m["scorer"].score_pairs(*c),
}
JAX_MODS = dict(bleu=j_bleu, meteor=j_meteor, rouge=j_rouge, cider=j_cider,
                tokenizer=j_tokenizer, stem=j_stem, retrieval=j_retrieval,
                scorer=j_scorer)
PORT_MODS = dict(bleu=t_bleu, meteor=t_meteor, rouge=t_rouge, cider=t_cider,
                 tokenizer=t_tokenizer, stem=t_stem, retrieval=t_retrieval,
                 scorer=t_scorer)


@pytest.mark.parametrize("corpus", ["random", "goldens"])
@pytest.mark.parametrize("metric", sorted(CASES))
def test_metric_equals_jax_exactly(metric, corpus):
    c = _corpus() if corpus == "random" else _goldens_corpus()
    want = CASES[metric](JAX_MODS, c)
    got = CASES[metric](PORT_MODS, c)
    assert got == want


def test_port_modules_are_its_own():
    for name, mod in PORT_MODS.items():
        assert mod.__name__ == f"mtn_tpu_torch.evalmetrics.{name}"
        assert mod is not JAX_MODS[name]


def test_evaluate_cli_writes_the_same_files(tiny_corpus, tmp_path, capsys):
    """annotation, hypotheses and score (--json) of both CLIs on a result
    JSON of the tiny corpus: byte-identical files and printed blocks."""
    c = tiny_corpus
    rng = np.random.default_rng(5)
    result = json.loads(open(c.test_set).read())
    for d in result["dialogs"]:
        d["dialog"] = d["dialog"][-1:]
        d["dialog"][0]["answer"] = make_dialog_json(
            rng, 1, 1)["dialogs"][0]["dialog"][0]["answer"]
    res_path = tmp_path / "result.json"
    res_path.write_text(json.dumps(result))
    stop = tmp_path / "stopwords.txt"
    stop.write_text("the\na\n")
    out = {}
    for name, cli in (("jax", jax_evaluate), ("port", t_evaluate)):
        d = tmp_path / name
        d.mkdir()
        ref, hyp, js = d / "ref.json", d / "hyp.json", d / "scores.json"
        assert cli.main(["annotation", "--last", "-s", str(stop),
                         c.lbl_test_set, str(ref)]) == 0
        assert cli.main(["hypotheses", "--last", "-s", str(stop),
                         str(res_path), str(hyp)]) == 0
        capsys.readouterr()
        assert cli.main(["score", "--json", str(js), str(ref),
                         str(hyp)]) == 0
        printed = capsys.readouterr().out
        out[name] = [p.read_bytes() for p in (ref, hyp, js)] + [printed]
    assert out["port"] == out["jax"]
    assert "Bleu_1:" in out["port"][3] and "CIDEr:" in out["port"][3]
