"""Prompt tokens the requests due in the window found in the prefix cache, over their prompt tokens, %."""
from bench import measure


def read(run):
    return measure.hit_share(run)
