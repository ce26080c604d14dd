"""Host milliseconds to build one of a pass's turn batches and upload it
(``make_batch``, then ``to_device_fn``, ending in a synchronize), timed
by the benchmark around the calls after the window; the mean over one
pass's batches."""


def read(obs):
    ms = obs.get("host_batch_ms") if obs.get("driver") == "decode" else None
    return sum(ms) / len(ms) if ms else None
