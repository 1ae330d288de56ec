"""Routed slots over the expert rows computed, % (program spans model_exec.launch inside the window: the sum of their moe_routed, each call's real tokens x top_k over the layers, over the sum of their moe_rows, the rows the expert GEMMs computed, E x C x batch rows, padding included); nothing where no launch carries them (a dense model, or a program without the attributes)."""
from bench import spans


def read(run):
    launches = spans.in_window(run, "model_exec.launch") or ()
    routed = [s.attrs for s in launches if s.attrs and "moe_rows" in s.attrs]
    rows = sum(a["moe_rows"] for a in routed)
    if not rows:
        return None
    return 100.0 * sum(a["moe_routed"] for a in routed) / rows
