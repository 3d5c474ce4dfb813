"""setup_s: from the process's start to the window's opening: weights,
the batcher and its captured tick, and the warm-up traffic."""


def read(rec):
    return rec.setup_s
