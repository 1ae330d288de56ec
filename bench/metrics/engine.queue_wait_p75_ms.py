"""75th percentile over the requests due in the window of their wait in the engine's queue (program span request.queued: Engine.add_request to the start of the first Engine.step whose plan holds the request), ms."""
from bench import spans


def read(run):
    return spans.request_p75_ms(run, "request.queued")
