"""Device memcpy time (D2H + H2D) over the profiled slice's wall, %."""
from bench import measure


def read(run):
    return measure.copy_share(run)
