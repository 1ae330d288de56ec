"""Training example (port of ``examples/train_resume.py``): a reduced
config trained with async checkpoints and a simulated crash at half the
steps; the restarted run restores the newest checkpoint and replays the
deterministic pipeline from there.

    PYTHONPATH=src python -m repro_torch.examples.train_resume   # the card
    PYTHONPATH=src python -m repro_torch.examples.train_resume --device cpu
"""
import argparse
import tempfile
import time

import torch

from ..configs import get_smoke
from ..models.model import init_params, resolve_device
from ..training import (CheckpointManager, TokenPipeline, init_adamw,
                        make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    opt = init_adamw(params)
    step_fn = make_train_step(cfg, remat=False, lr=3e-3)
    pipe = TokenPipeline(cfg.vocab, batch=8, seq=64, seed=0,
                         enc_frames=cfg.enc_frames, d_model=cfg.d_model)

    def batch(i):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in pipe.batch_at(i).items()}

    with tempfile.TemporaryDirectory(prefix="proserve_ck_") as ckdir:
        mgr = CheckpointManager(ckdir, keep=2)
        t0, losses = time.time(), []
        crash_at = args.steps // 2
        for i in range(crash_at):
            params, opt, m = step_fn(params, opt, batch(i))
            losses.append(float(m["loss"]))
            if i % 20 == 19:
                mgr.save_async(i + 1, {"p": params, "o": opt})
                print(f"step {i+1:4d} loss {losses[-1]:.3f} "
                      f"(async checkpoint)")
        mgr.wait()
        print(f"\n-- simulated crash at step {crash_at} --")

        restored, at = mgr.restore({"p": params, "o": opt})
        params, opt = restored["p"], restored["o"]
        print(f"restarted from checkpoint step {at}; replaying pipeline...")
        for i in range(at, args.steps):
            params, opt, m = step_fn(params, opt, batch(i))
            losses.append(float(m["loss"]))
            if i % 20 == 19:
                print(f"step {i+1:4d} loss {losses[-1]:.3f}")

    print(f"\ntrained {args.steps} steps (with restart) in "
          f"{time.time()-t0:.1f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss should descend"
    return {"losses": losses, "crash_at": crash_at, "restored_at": at}


if __name__ == "__main__":
    main()
