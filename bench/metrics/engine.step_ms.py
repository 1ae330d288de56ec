"""Host time in Engine.step, summed over the steps that began and ended inside the window (a step ends in its one host sync), ms."""
from bench import measure


def read(run):
    return measure.spans_ms(run, "steps")
