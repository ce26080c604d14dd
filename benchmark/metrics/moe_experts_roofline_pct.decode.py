"""Percent of the HBM roofline (3.35e12 B/s, H100 SXM) that the routed
experts' grouped GEMMs reach in one eager batch's decode steps of a
language-model decode cell: the bytes each step's own routing asks of
them (``benchmark/harness/lm_counts.py``) over their device time under
the profiler (``drivers/decode_lm.py``)."""


def read(obs):
    experts = obs.get("moe_experts") if obs.get("driver") == "decode" \
        else None
    return experts["roofline_pct"] if experts else None
