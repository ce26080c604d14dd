"""Percent of the card's bf16 peak (989e12 FLOP/s, H100 SXM at 700 W)
that the window's model FLOPs fill: the products of the encoders, each
layer's auto-encoder and cross-attention keys and values, and each
turn's beam rows over the steps its n-best needs (its longest returned
hypothesis plus one), counted from the turn's own lengths
(``benchmark/harness/flops.py``), over the window's seconds."""


def read(obs):
    if obs.get("driver") != "decode" or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / (obs["window_s"] * obs["peak_flops"])
