"""Scheduling rounds inside the window that admitted nothing while requests were queued (program span sched.form_batch with a reason), over the rounds inside the window that ran with requests queued, % (0 where none ran with requests queued; nothing where the program recorded no round)."""
from bench import spans


def read(run):
    return spans.empty_round_share(run)
