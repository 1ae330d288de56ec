"""Device idle time in the profiled slice while the engine's thread was issuing a model call's forward (program span model_exec.launch), over the slice's wall, %."""
from bench import spans


def read(run):
    return spans.launch_idle_share(run)
