"""Training entry point on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --smoke --steps 100 --batch 8 --seq 128

Runs on the card unless ``--device cpu``.  ``--smoke`` (the default)
trains the reduced config; ``--no-smoke`` the full one.  Resumes from the
latest checkpoint in ``--ckpt-dir`` automatically: the data is a pure
function of the step and the schedule reads the restored step, so a
resumed run replays the uninterrupted one.  Includes straggler
monitoring.  One card needs no mesh and no parameter shardings.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config, smoke_batch
from ..device import resolve_device
from ..distributed import CheckpointManager, StragglerMonitor
from ..models import build_model
from ..optim import AdamWConfig
from ..training import init_training, make_train_step

#: the data stream's seed, the reference's
DATA_SEED = 1234


def make_batches(cfg, batch: int, seq: int, seed: int):
    """LM data pipeline: deterministic + restart-safe (pure function of
    the step index — resume replays the identical remaining stream)."""
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        from ..data import token_stream

        def at_step(step: int):
            return token_stream(cfg.vocab, batch, seq, seed=seed,
                                step=step)
        return at_step

    def at_step(step: int):
        return smoke_batch(cfg, batch=batch, seq=seq, seed=seed + step)

    return at_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="out/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, dev, training=True)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                          total_steps=args.steps)
    params, opt_state = init_training(
        model, torch.Generator(device=dev).manual_seed(args.seed))
    step_fn = make_train_step(model, opt_cfg, microbatch=args.microbatch)

    cm = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if cm.latest_step() is not None:
        restored, man = cm.restore({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = man["step"] + 1
        print(f"resumed from step {man['step']}")

    batches = make_batches(cfg, args.batch, args.seq, seed=DATA_SEED)
    mon = StragglerMonitor(
        on_warn=lambda e: print(f"  [straggler] step {e.step} "
                                f"{e.ratio:.1f}x median"))
    t_start = time.time()
    loss = float("nan")
    for step in range(start, args.steps):
        mon.start_step(step)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             batches(step))
        loss = float(metrics["loss"])          # waits for the step
        mon.end_step()
        if step % args.log_every == 0 or step == args.steps - 1:
            toks = args.batch * args.seq
            dt = (time.time() - t_start) / max(1, step - start + 1)
            print(f"step {step:5d}  loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"{toks / dt:.0f} tok/s", flush=True)
        if step % args.ckpt_every == args.ckpt_every - 1:
            cm.save(step, {"params": params, "opt": opt_state},
                    extra={"loss": loss})
    cm.save(args.steps - 1, {"params": params, "opt": opt_state},
            blocking=True)
    print(f"done: {args.steps - start} steps in "
          f"{time.time() - t_start:.1f}s; checkpoints in "
          f"{args.ckpt_dir}", flush=True)
    return {"start": start, "steps": args.steps, "loss": loss,
            "device": str(dev)}


if __name__ == "__main__":
    main()
