"""1 - the union of kernel and copy intervals over the profiled slice's wall, %."""
from bench import measure


def read(run):
    return measure.idle_share(run)
