"""75th percentile over the requests due in the window of their wait in the engine driver's inbox (program span request.inbox: EngineDriver.submit to the driver loop taking it to add_request), ms."""
from bench import spans


def read(run):
    return spans.request_p75_ms(run, "request.inbox")
