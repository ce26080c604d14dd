"""Device milliseconds of one turn batch's prefill in a language-model
decode cell: the kernels inside the span ``lm.prefill`` of one recorded
eager batch, after the window (``drivers/decode_lm.py``)."""


def read(obs):
    if obs.get("driver") != "decode":
        return None
    return obs.get("lm_prefill_ms")
