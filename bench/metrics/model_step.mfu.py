"""FLOPs the served tokens need (2 x active parameters a token, attention over the context, logits where sampled) over the slice at the fp32 peak, %."""
from bench import measure


def read(run):
    return measure.mfu(run)
