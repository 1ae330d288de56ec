"""The check that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the requests the run finished, drawn from the seed, is read again by
the plain fp32 reference of ``bench/reference/``: each prompt with the
tokens its client received, in one forward pass.  Compared with the
configuration's limit: the widest gap by which a served token's logit
lies below the reference's best at its position (every served token is
greedy).  The sample always holds the request with the longest output
and, where the configuration asks for it, one that took blocks from the
prefix cache.

The control goes through the same ``check`` with ``control_gaps`` in
place of ``served_gaps``: at the same positions, the reference with TF32
matmuls, the precision below the configuration's fp32, stands in for the
program, and its first choice is scored by the fp32 reference.
"""
from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch


def reference(config: dict):
    return importlib.import_module(f"bench.reference.{config['reference']}")


def sample(cell, run, seed: int) -> list:
    chk = cell.config["check"]
    done = [r for r in run.recs if r.complete]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    chosen = [max(done, key=lambda r: (r.output_len, -r.planned.idx))]
    want = chk.get("include", [])
    if "prefix_hit" in want:
        hit = [r for r in done if r.planned.prefix >= 0 and r not in chosen]
        if hit:
            chosen.append(hit[int(rng.integers(len(hit)))])
    rest = [r for r in done if r not in chosen]
    for i in rng.permutation(len(rest)):
        if (sum(r.output_len for r in chosen) >= chk["sample_tokens"]
                or len(chosen) >= chk["sample_requests"]):
            break
        chosen.append(rest[int(i)])
    return chosen


def _inputs(rec, device):
    prompt = np.asarray(rec.planned.prompt, np.int64)
    served = np.asarray(rec.tokens[:rec.output_len], np.int64)
    tokens = torch.from_numpy(np.concatenate([prompt, served[:-1]])).to(
        device)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served),
                        device=device)
    return tokens, rows, torch.from_numpy(served).to(device)


def served_gaps(config, weights, rec) -> np.ndarray:
    """Per served token: the reference's best logit minus the served
    token's."""
    ref = reference(config)
    tokens, rows, served = _inputs(rec, weights["embed"].device)
    lg = ref.logits(config, weights, tokens, rows)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    return gap.double().cpu().numpy()


def control_gaps(config, weights, rec) -> np.ndarray:
    """Per position: the fp32 reference's best logit minus its logit of
    the token that the TF32 reference puts first."""
    ref = reference(config)
    tokens, rows, _ = _inputs(rec, weights["embed"].device)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg = ref.logits(config, weights, tokens, rows)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        pick = ref.logits(config, weights, tokens, rows).argmax(-1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    gap = lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0]
    return gap.double().cpu().numpy()


def check(cell, run, weights, seed: int, log=print,
          gaps=served_gaps) -> dict:
    """The numbers compared, each with its limit, and whether all hold.
    ``gaps(config, weights, rec)`` reads one request of the sample: the
    program's served tokens, or the control's choices."""
    t0 = time.monotonic()
    chk = cell.config["check"]
    picked = sample(cell, run, seed)
    widest, n_tok, n_off = 0.0, 0, 0
    for rec in picked:
        g = gaps(cell.config, weights, rec)
        widest = max(widest, float(g.max()))
        n_tok += len(g)
        n_off += int((g > 0).sum())
    # each finished stream carries exactly its output length
    bad_len = sum(1 for r in run.recs
                  if r.error is None and len(r.tokens) > r.output_len)
    lim = chk["max_logit_gap"]
    numbers = {
        "max_logit_gap": {"value": widest, "limit": lim,
                          "holds": widest <= lim},
        "tokens_checked": {"value": n_tok, "limit": chk["min_tokens"],
                           "holds": n_tok >= chk["min_tokens"]},
        "overlong_streams": {"value": bad_len, "limit": 0,
                             "holds": bad_len == 0}}
    ok = all(v["holds"] for v in numbers.values())
    log(f"check: {len(picked)} requests, {n_tok} tokens against the "
        f"reference in {time.monotonic() - t0:.1f} s; widest gap {widest!r}, "
        f"{n_off} not its first choice", file=sys.stderr)
    return {"correct": ok, "numbers": numbers,
            "readings": {"max_logit_gap": widest, "not_first_choice": n_off},
            "requests": [r.planned.idx for r in picked],
            "seconds": time.monotonic() - t0}
