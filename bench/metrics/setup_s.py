"""Process start to the first arrival of the ramp (host clock), s."""


def read(run):
    return run.setup_s
