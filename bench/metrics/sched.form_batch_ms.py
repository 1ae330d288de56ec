"""Host time in the engine policy's form_batch, summed over the calls that began and ended inside the window, ms."""
from bench import measure


def read(run):
    return measure.spans_ms(run, "forms")
