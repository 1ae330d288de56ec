"""Decode model calls inside the window that ran as one CUDA graph replay (program span model_exec.launch of kind decode with graph 1), over every decode model_exec.launch span inside the window, % (0 where the spans carry no graph attribute; nothing where the program recorded no decode launch)."""
from bench import spans


def read(run):
    launches = spans.in_window(run, "model_exec.launch")
    decode = [s for s in launches or ()
              if s.attrs and s.attrs.get("kind") == "decode"]
    if not decode:
        return None
    return 100.0 * sum(s.attrs.get("graph") == 1 for s in decode) \
        / len(decode)
