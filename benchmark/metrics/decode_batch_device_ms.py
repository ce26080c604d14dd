"""Device milliseconds a warm graphed turn batch takes: CUDA events
bracket each launch of one pass of batches, 8 in flight, on a decoder
the benchmark holds."""


def read(obs):
    held = obs.get("held") if obs.get("driver") == "decode" else None
    return 1e3 * held["busy_s"] / held["batches"] if held else None
