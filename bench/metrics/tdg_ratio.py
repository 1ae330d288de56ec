"""TDG_Ratio (w_p = 4) over the requests due in the window; a failed request adds its ideal gain to the denominator only."""
from bench import measure


def read(run):
    return measure.tdg(run)
