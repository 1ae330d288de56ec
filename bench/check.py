"""The check that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the requests the run finished, drawn from the seed, is read again by
the plain fp32 reference of ``bench/reference/``: each prompt with the
tokens its client received, in one forward pass.  The sample always
holds the request with the longest output and, where the configuration
asks for it, one that took blocks from the prefix cache.  Every served
token is greedy, so each is scored by its gap: the reference's best
logit at its position less the reference's logit of the served token.

The configuration's ``check.rule`` names how the gaps are judged:

* ``max_logit_gap`` (the default): the widest gap at most the
  configuration's ``max_logit_gap``.
* ``routed``, for a model whose layers route each token to some of their
  experts (``routed_rule``).

The control goes through the same ``check`` with ``control_gaps`` in
place of ``served_gaps``: at the same positions, the reference with TF32
matmuls, the precision below the configuration's fp32, stands in for the
program, and its first choice is scored by the fp32 reference.
"""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

RULES = ("max_logit_gap", "routed")


def rule(config: dict) -> str:
    name = config["check"].get("rule", "max_logit_gap")
    if name not in RULES:
        raise ValueError(f"no check rule {name!r}; the rules are {RULES}")
    return name


def reference(root, config: dict):
    """The configuration's reference module, from the checkout at
    ``root`` (a cell added by files alone brings its own)."""
    name = config["reference"]
    path = Path(root) / "bench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.reference.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def served_gaps(ref, config, weights, rec) -> np.ndarray:
    """Per served token: the reference's best logit minus the served
    token's."""
    tokens, rows, served = _inputs(rec, weights["embed"].device)
    lg = ref.logits(config, weights, tokens, rows)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    return gap.double().cpu().numpy()


def control_gaps(ref, config, weights, rec) -> np.ndarray:
    """Per position: the fp32 reference's best logit minus its logit of
    the token that the TF32 reference puts first."""
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


ROUTED_LIMITS = ("gap_tol", "max_departing_share", "min_requests",
                 "min_tokens")


def routed_rule(per_request: list, chk: dict) -> tuple:
    """The routed rule over the sample's requests, each given as its
    served tokens' gaps: (numbers, readings).

    A routed layer sends each token to its k experts of highest router
    logit.  Where the k-th and the (k+1)-th logits are nearly equal (a
    near-tie), rounding alone can choose the other expert: two fp32
    computations that sum in another order depart there.  The token's
    hidden state then moves by a gated expert's whole output, its keys
    and values with it, so every later token of the request reads another
    context and meets near-ties of its own: one near-tie, in the prompt as
    well as in the served tokens, can make a request depart from the
    reference on a third of its tokens, as a lower precision does on every
    request.  So no limit on a token's gap holds a sound program, and
    excusing a token by its own router margin does not either (a departure
    that follows a near-tie earlier in the request has no tie of its
    own).  The rule judges requests instead: a request's *departing share*
    is the share of its served tokens whose gap exceeds ``gap_tol``, which
    rounding at a near-tie of the vocabulary stays under, and the mean of
    the sample's shares must be at most ``max_departing_share``.  A sound
    program departs so on few requests, which the mean over at least
    ``min_requests`` requests (and ``min_tokens`` tokens) dilutes; a lower
    precision, or a routing with part left out (an expert fewer, gates
    normalised another way, an expert's output lost), departs on every
    request, and a fault in half of a batch on half of them.  The
    configuration gives each limit with its reason under ``check.why``.
    """
    missing = [k for k in ROUTED_LIMITS
               if k not in chk or k not in chk.get("why", {})]
    if missing:
        raise ValueError(f"the routed rule needs each of {ROUTED_LIMITS} "
                         f"in the configuration's check, with its reason "
                         f"under check.why; missing: {missing}")
    shares = [float((g > chk["gap_tol"]).mean()) for g in per_request]
    mean = float(np.mean(shares)) if shares else 1.0
    n_tok = sum(len(g) for g in per_request)
    lim = chk["max_departing_share"]
    numbers = {
        "departing_share": {"value": mean, "limit": lim,
                            "holds": mean <= lim},
        "requests_checked": {"value": len(shares),
                             "limit": chk["min_requests"],
                             "holds": len(shares) >= chk["min_requests"]},
        "tokens_checked": {"value": n_tok, "limit": chk["min_tokens"],
                           "holds": n_tok >= chk["min_tokens"]}}
    gaps = np.concatenate(per_request) if per_request else np.zeros(0)
    readings = {"departing_share": mean, "shares": shares,
                "max_logit_gap": float(gaps.max()) if gaps.size else 0.0,
                "not_first_choice": int((gaps > 0).sum())}
    return numbers, readings


def check(cell, run, weights, seed: int, log=print,
          gaps=served_gaps) -> dict:
    """The numbers compared, each with its limit, and whether all hold.
    ``gaps(ref, config, weights, rec)`` reads one request of the sample:
    the program's served tokens, or the control's choices."""
    t0 = time.monotonic()
    chk = cell.config["check"]
    ref = reference(cell.root, cell.config)
    picked = sample(cell, run, seed)
    widest, n_tok, n_off = 0.0, 0, 0
    per_request = []
    for rec in picked:
        g = gaps(ref, cell.config, weights, rec)
        widest = max(widest, float(g.max()))
        n_tok += len(g)
        n_off += int((g > 0).sum())
        per_request.append(g)
    # each finished stream carries exactly its output length
    bad_len = sum(1 for r in run.recs
                  if r.error is None and len(r.tokens) > r.output_len)
    if rule(cell.config) == "routed":
        numbers, readings = routed_rule(per_request, chk)
    else:
        lim = chk["max_logit_gap"]
        numbers = {
            "max_logit_gap": {"value": widest, "limit": lim,
                              "holds": widest <= lim},
            "tokens_checked": {"value": n_tok, "limit": chk["min_tokens"],
                               "holds": n_tok >= chk["min_tokens"]}}
        readings = {"max_logit_gap": widest, "not_first_choice": n_off}
    numbers["overlong_streams"] = {"value": bad_len, "limit": 0,
                                   "holds": bad_len == 0}
    ok = all(v["holds"] for v in numbers.values())
    log(f"check: {len(picked)} requests, {n_tok} tokens against the "
        f"reference in {time.monotonic() - t0:.1f} s; widest gap {widest!r}, "
        f"{n_off} not its first choice", file=sys.stderr)
    return {"correct": ok, "numbers": numbers, "readings": readings,
            "requests": [r.planned.idx for r in picked],
            "seconds": time.monotonic() - t0}
