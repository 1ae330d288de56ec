"""95th percentile of how late each submit ran behind its due time (harness clock), ms; requests due while the profiler starts or stops are left out."""
from bench import measure


def read(run):
    return measure.p95(measure.late_ms(run), 1e3 * measure.cap_s(run))
