"""Faults planted under the decode cells' timed path, for the check's
tests (``benchmark/tests/test_bench_check.py``) and for readings on the
card (``tools/readings.py --fault``). Each has to come out as not
correct.

The step faults act from the decoder position ``start`` on and take the
position as the 0-d device tensor the loop holds, with no read to the
host, so they run inside the captured loop as in the eager one.

- ``kv_unwritten``: the beam step hands back the self-attention KV
  caches it was given, so the positions from ``start`` on are never
  written;
- ``token_altered``: each new token from position ``start`` on is
  changed where the step writes it;
- ``half_left_out``: half of each batch's turns come back with no
  hypothesis.
"""

from __future__ import annotations

import torch


def kv_unwritten(step, start: int = 0):
    def broken(*args, **kw):
        l = args[1]
        kept = tuple((k.clone(), v.clone()) for k, v in args[7])
        out = step(*args, **kw)
        late = l >= start
        kv = tuple((torch.where(late, k0, k1), torch.where(late, v0, v1))
                   for (k0, v0), (k1, v1) in zip(kept, out[-1]))
        return (*out[:-1], kv)
    return broken


def token_altered(step, start: int = 0):
    def broken(*args, **kw):
        tok_buf, *rest = step(*args, **kw)
        l = args[1]
        pos = (l + 1).reshape(1)
        alt = 4 + (tok_buf.index_select(2, pos) + 1) % 50
        tok_buf = torch.where(l + 1 >= start,
                              tok_buf.index_copy(2, pos, alt), tok_buf)
        return (tok_buf, *rest)
    return broken


def half_left_out(results):
    def broken(raw, valid):
        out = results(raw, valid)
        for r in out[1::2]:
            r.tokens, r.scores = [[]], [0.0]
        return out
    return broken


STEP_FAULTS = {"kv_unwritten": kv_unwritten, "token_altered": token_altered}
FAULTS = (*STEP_FAULTS, "half_left_out")


def plant(name: str, start: int = 0):
    """Plant the fault ``name`` in the imported program; returns a
    function that takes it out again."""
    from mtn_tpu_torch.decode import beam
    if name == "half_left_out":
        attr, old = "beam_results", beam.BeamDecoder.__dict__["beam_results"]
        setattr(beam.BeamDecoder, attr,
                staticmethod(half_left_out(beam.BeamDecoder.beam_results)))
        return lambda: setattr(beam.BeamDecoder, attr, old)
    old = beam.beam_step
    beam.beam_step = STEP_FAULTS[name](old, start)
    return lambda: setattr(beam, "beam_step", old)
