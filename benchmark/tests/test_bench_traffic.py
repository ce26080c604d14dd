"""The generator: deterministic in the seed, one set of sizes for every
seed."""

import json

import numpy as np

from benchmark.harness import traffic
from conftest import TINY
import os

MIX = json.load(open(os.path.join(os.path.dirname(TINY), "traffic",
                                  "tiny.json")))
STREAMS = {"i3d_flow": 24, "vggish": 12}


def lengths(c):
    return sorted((len(d["caption"].split()), len(d["summary"].split()),
                   tuple(len(t["question"].split()) for t in d["dialog"]),
                   tuple(len(t["answer"].split()) for t in d["dialog"][:-1]),
                   tuple(len(a) for a in c.features[d["image_id"]]))
                  for d in c.dialogs)


def test_deterministic_in_the_seed():
    a = traffic.make_dialogs(MIX, 2 ** 31 + 5, 60, STREAMS)
    b = traffic.make_dialogs(MIX, 2 ** 31 + 5, 60, STREAMS)
    assert a.dialogs == b.dialogs
    for v in a.features:
        for x, y in zip(a.features[v], b.features[v]):
            np.testing.assert_array_equal(x, y)


def test_seeds_share_the_sizes_in_another_order():
    a = traffic.make_dialogs(MIX, 1, 60, STREAMS)
    b = traffic.make_dialogs(MIX, 2, 60, STREAMS)
    assert a.dialogs != b.dialogs
    assert lengths(a) == lengths(b)
    assert all(d["dialog"][-1]["answer"] == traffic.UNDISCLOSED
               for d in a.dialogs)


def test_corpus_on_disk(tmp_path):
    c = traffic.write_corpus(traffic.make_dialogs(MIX, 3, 60, STREAMS),
                             str(tmp_path))
    assert json.load(open(c.test_set))["dialogs"] == c.dialogs
    v = c.dialogs[0]["image_id"]
    got = np.load(c.fea_path.replace("<FeaType>", "vggish").replace(
        "<ImageID>", v))
    np.testing.assert_array_equal(got, c.features[v][1])
