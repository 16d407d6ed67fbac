"""Serving entry point: continuous-batched greedy decoding, on the card unless
``--device cpu`` is given.  Every architecture of ``configs`` but the
encoder-decoder one (whisper-small, whose prompts need audio frames that
a token request does not carry: ``greedy_generate`` serves it).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --smoke --requests 8 --slots 4 --max-new 16 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..training import ContinuousBatcher, Request


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    # prefill attention through the hand-written kernel on the card; a CPU
    # run takes the plain version
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              use_flash=True)
    model = build_model(cfg, device=args.device)
    if cfg.family == "encdec":
        raise ValueError(
            f"{args.arch}: the encoder-decoder family needs audio 'frames' "
            f"with each prompt, and ContinuousBatcher's requests carry "
            f"tokens only; serve it with training.greedy_generate and a "
            f"batch that holds the frames")
    rng = np.random.default_rng(0)

    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    batcher = ContinuousBatcher(model, params, slots=args.slots,
                                max_len=args.max_len)
    for i in range(args.requests):
        batcher.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab,
                                (args.prompt_len,)).astype(np.int32),
            max_new=args.max_new))
    t0 = time.time()
    done = batcher.run()
    wall = time.time() - t0
    total = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total} tokens in "
          f"{wall:.2f}s ({total / wall:.1f} tok/s, "
          f"{args.slots} slots)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")


if __name__ == "__main__":
    main()
