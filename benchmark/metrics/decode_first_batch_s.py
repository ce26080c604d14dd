"""Seconds from a pass's start to its first fetched batch (the eager
batch and, behind it, the capture), from ``generate_responses``' stats,
averaged over the window's passes."""


def read(obs):
    passes = obs.get("passes") if obs.get("driver") == "decode" else None
    if not passes:
        return None
    return sum(p["first_batch_seconds"] for p in passes) / len(passes)
