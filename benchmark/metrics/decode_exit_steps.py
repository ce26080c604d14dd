"""Mean steps the early-stop beam loop ran a batch (``mean_exit_step``
of ``generate_responses``' stats), averaged over the window's passes."""


def read(obs):
    passes = obs.get("passes") if obs.get("driver") == "decode" else None
    if not passes:
        return None
    return sum(p["mean_exit_step"] for p in passes) / len(passes)
