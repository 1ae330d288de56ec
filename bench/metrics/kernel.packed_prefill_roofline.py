"""Roofline bound per packed_prefill_kernel launch over its mean device time, %."""
from bench import measure


def read(run):
    return measure.prefill_roofline(run)
