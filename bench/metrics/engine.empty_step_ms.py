"""Host time in the Engine.step calls that formed no batch while the
engine held work (the policy's plan came back empty), summed over the
calls that began and ended inside the window, ms (0 where there were
none)."""
from bench import measure


def read(run):
    return measure.spans_ms(run, "empty_steps") or 0.0
