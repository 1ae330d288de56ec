"""Training launcher of the port (counterpart of ``repro.launch.train``):
trains a config on the card, full published width by default, with the
reference's flags; ``--smoke`` takes the reduced config the reference
trains, ``--device cpu`` the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``train`` is the loop itself, for callers that want its losses, step
times and final state (``chip_smoke.py``'s ``train`` phase).  fp32 runs
in full fp32: TF32 is switched off.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get, get_smoke
from ..models.model import ArchConfig, init_params, resolve_device
from ..training import (CheckpointManager, TokenPipeline, init_adamw,
                        make_train_step)


def train(cfg: ArchConfig, *, steps: int = 50, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, device="cuda",
          compress_grads: bool = False, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, cycle: int = 0,
          verbose: bool = True) -> dict:
    """Train ``steps`` steps from random weights (seed 0) on the
    deterministic ``TokenPipeline`` (step i reads batch i, or i % ``cycle``
    to memorize a small set), remat off as the reference's launcher,
    resuming from ``ckpt_dir``'s newest checkpoint if there is one and
    saving every ``ckpt_every`` steps.
    Returns the final ``params`` / ``opt``, the first step run
    (``start``), and per step ``losses``, ``grad_norms`` and ``step_s``
    (wall seconds, the host waiting for the loss)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    opt = init_adamw(params, compress=compress_grads)
    step_fn = make_train_step(cfg, remat=False, lr=lr,
                              compress_grads=compress_grads)
    pipe = TokenPipeline(cfg.vocab, batch, seq, seed=0,
                         enc_frames=cfg.enc_frames, d_model=cfg.d_model)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, start = mgr.restore({"p": params, "o": opt})
        params, opt = restored["p"], restored["o"]
        if verbose:
            print(f"resumed from step {start}")

    out = {"start": start, "losses": [], "grad_norms": [], "step_s": []}
    t0 = time.time()
    for i in range(start, steps):
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.batch_at(i % cycle if cycle else i).items()}
        t_step = time.perf_counter()
        params, opt, m = step_fn(params, opt, b)
        loss = float(m["loss"])
        out["step_s"].append(time.perf_counter() - t_step)
        out["losses"].append(loss)
        out["grad_norms"].append(float(m["grad_norm"]))
        if verbose and (i % 10 == 0 or i == steps - 1):
            print(f"step {i:5d} loss {loss:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f}", flush=True)
        if mgr is not None and (i + 1) % ckpt_every == 0:
            mgr.save_async(i + 1, {"p": params, "o": opt})
    if mgr is not None:
        mgr.wait()
    if verbose:
        print(f"done: {steps - start} steps in {time.time() - t0:.1f}s")
    out.update(params=params, opt=opt)
    return out


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced SMOKE config (default: full width)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, device=args.device,
                 compress_grads=args.compress_grads, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
