"""Responses of all the window's whole passes over the window's seconds
(each pass with its eager first batch, its capture, and the collection
of its decoder after it)."""


def read(obs):
    passes = obs.get("passes") if obs.get("driver") == "decode" else None
    if not passes:
        return None
    return sum(p["responses"] for p in passes) / obs["window_s"]
