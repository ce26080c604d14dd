"""Seconds from the process's start to the first timed pass: imports,
the card's start, the traffic written and loaded, the weights made, one
warm pass over a few dialogs with the split's batch shape (the kernels'
build in a new checkout)."""


def read(obs):
    return obs.get("setup_s")
