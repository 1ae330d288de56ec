"""Roofline bound per paged_decode_kernel launch (shapes from the engine) over its mean device time, %."""
from bench import measure


def read(run):
    return measure.decode_roofline(run)
