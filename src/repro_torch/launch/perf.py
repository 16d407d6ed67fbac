"""Perf hillclimb: re-traces the three chosen cells with one
knob flipped per iteration and records before/after JSON pairs in
experiments/perf/.  A run that fails (the MoE cells do not trace yet)
writes ``<name>.FAIL`` with its traceback and the next run goes on, as
in ``dryrun.run_cells``.  The reference's grouped MoE dispatch runs
(its A1, A2 and A3) are left out: the port's MoE has the flat dispatch
only.

    PYTHONPATH=src python -m repro_torch.launch.perf --thread A
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch

from .dryrun import lower_cell
from .mesh import production_mesh

OUT = "experiments/perf"


def save(name, mesh, arch, shape, **knobs):
    """Trace one cell with ``knobs`` and write ``<name>.json``, or
    ``<name>.FAIL`` with the traceback when the trace fails."""
    os.makedirs(OUT, exist_ok=True)
    try:
        rec = lower_cell(arch, shape, mesh, **knobs)
    except Exception as e:     # noqa: BLE001 — one run's failure
        print(f"{name:52s} FAIL {type(e).__name__}: {e}", flush=True)
        with open(os.path.join(OUT, name + ".FAIL"), "w") as fh:
            fh.write(traceback.format_exc())
        return None
    with open(os.path.join(OUT, name + ".json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    ro = rec["roofline"]
    print(f"{name:52s} mem/dev={rec['memory']['peak_estimate'] / 2**30:7.2f}GiB "
          f"comp={ro['compute_s'] * 1e3:9.1f} mem={ro['memory_s'] * 1e3:9.1f} "
          f"coll={ro['collective_s'] * 1e3:9.1f} -> {ro['bottleneck']}",
          flush=True)
    return rec


def thread_a(mesh):
    """qwen3-moe train_4k: MoE dispatch collective volume (flat)."""
    save("A0_qwen3_train_flat", mesh, "qwen3-moe-235b-a22b", "train_4k",
         microbatch=8, remat_policy="nothing")


def thread_b(mesh):
    """granite-34b decode_32k: serving memory floor."""
    save("B0_g34_decode_fp32params", mesh, "granite-34b", "decode_32k")
    save("B1_g34_decode_bf16params", mesh, "granite-34b", "decode_32k",
         param_dtype=torch.bfloat16)


def thread_b2(mesh):
    """B2: is the decode collective the seq-sharded (split-K) cache?"""
    save("B2_g34_decode_no_kvseq", mesh, "granite-34b", "decode_32k",
         rules_overrides={"kv_seq": None})


def thread_b3(mesh):
    """B3: TP-only bf16 weights for serving (no per-layer FSDP weight
    all-gathers; decode batch can't amortise them)."""
    save("B3_g34_decode_tp_only_bf16", mesh, "granite-34b", "decode_32k",
         param_dtype=torch.bfloat16, serve_params="serve")


def thread_c(mesh):
    """llava train_4k: 56 heads don't divide the 16-way TP axis."""
    base = dict(microbatch=16, remat_policy="nothing")
    save("C0_llava_train_replicated_heads", mesh, "llava-next-34b",
         "train_4k", **base)
    save("C1_llava_train_seqshard", mesh, "llava-next-34b", "train_4k",
         seq_fallback=True, **base)
    # C2: seq-fallback + tighter microbatch
    save("C2_llava_train_seqshard_dots", mesh, "llava-next-34b", "train_4k",
         seq_fallback=True, microbatch=16, remat_policy="dots")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--thread", default="all",
                    choices=["A", "B", "B2", "B3", "C", "all", "round2"])
    args = ap.parse_args()
    with production_mesh() as mesh:
        run_threads(args.thread, mesh)


def run_threads(thread: str, mesh) -> None:
    if thread in ("A", "all"):
        thread_a(mesh)
    if thread in ("B", "all"):
        thread_b(mesh)
    if thread in ("C", "all"):
        thread_c(mesh)
    if thread in ("B2", "round2"):
        thread_b2(mesh)
    if thread in ("B3", "round2"):
        thread_b3(mesh)


if __name__ == "__main__":
    main()
