"""Multi-pod dry-run: trace every (architecture × input shape × mesh)
cell on the production mesh with fake tensors, record its memory and
work per device, and derive the roofline terms.

The reference lowers and compiles each cell with XLA on 512 faked host
devices; the port traces it eagerly: the model's weights are DTensors
on a fake 256- or 512-rank ``DeviceMesh`` (``launch.mesh``), placed by
``param_shardings``, and the cell's step (a train step: forward,
backward and AdamW; a prefill; or a decode against ``init_cache``) runs
under ``use_rules(make_rules(mesh))`` on fake tensors, so nothing is
allocated and no collective moves a byte.  Three readers watch the local
shards beneath DTensor: ``roofline.Counter`` (flops, bytes, collectives
per device), ``CommDebugMode`` (DTensor's collective counts) and
``core.transport._PeakMemory`` (the step's live bytes).  Attention and
the kernels take their plain paths (``use_flash=False``), as the
reference's dry-run does: a hand-written kernel takes raw pointers,
which a fake tensor has not.

Record keys are the reference's.  ``lower_s`` is the time to build and
place the model and inputs; ``compile_s`` is the time to trace the step
(the port compiles nothing).  ``memory.peak_estimate`` is the high-water
mark of live local bytes: the step's inputs (``argument_bytes``: the
weights, optimizer state or cache, and batch this rank holds) plus the
most bytes the step's own tensors hold at once (``temp_bytes``), with
donated inputs updated in place (the port's train step and decode
update the weights, moments and cache in place, so ``alias_bytes`` is
what they hold and ``output_bytes`` the new outputs' bytes).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh pod                              # one cell
    ... --mesh both --out experiments/dryrun                     # default
    ... --arch qwen3-moe-235b-a22b --moe-grouped      # tags end __grouped

Results are cached as JSON per cell; reruns skip completed cells unless
--force.  A cell that fails writes ``<tag>.FAIL`` with its traceback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_leaves

from ..configs import (ARCH_IDS, SHAPES, all_cells, cell_supported,
                       get_config, input_specs)
from ..core.transport import _PeakMemory
from ..distributed.param_sharding import batch_shardings, distribute_params
from ..models import build_model, make_rules, use_rules
from ..models.sharding import distribute, mesh_axes
from ..optim import AdamWConfig, init_opt_state
from ..roofline.analysis import HBM_BYTES, analyse
from ..roofline.counter import Counter
from ..training import make_serve_step, make_train_step
from .mesh import fake_tensors, production_mesh

OUT_DIR = "experiments/dryrun"
#: the card's memory, the line the memory ladder keeps a cell under
HBM_PER_CHIP = HBM_BYTES


def _local_bytes(tree: Any) -> int:
    """Bytes this rank holds of every tensor in ``tree``."""
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _global_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _state_leaves(tree: Any) -> list:
    """The tensors of a module, dict, tuple or list (opt state, cache)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _placed_batch(specs: dict, mesh, n_chunks: int) -> dict:
    """One of ``n_chunks`` microbatch chunks of the step's inputs, each
    leaf a DTensor placed by ``batch_shardings`` (zeros: the dry-run
    reads shapes only)."""
    shapes = {k: (s.shape[0] // n_chunks,) + tuple(s.shape[1:])
              for k, s in specs.items()}
    sh = batch_shardings(shapes, mesh)
    return {k: distribute(torch.zeros(shapes[k], dtype=s.dtype,
                                      device=mesh.device_type), mesh, sh[k])
            for k, s in specs.items()}


def cut_depth(cfg, n_layers: int) -> dict:
    """Config fields for ``cfg`` cut to about ``n_layers`` layers: the
    smallest whole number of its layer groups (llama4's dense + MoE
    pair, Zamba2's Mamba blocks per shared attention, xLSTM's mLSTM
    blocks per sLSTM) that holds ``n_layers``, at most the config's own
    depth; Whisper's encoder is cut alike."""
    period = cfg.moe_every or cfg.attn_every or cfg.slstm_every or 1
    n = min(cfg.n_layers, -(-max(n_layers, 1) // period) * period)
    out = {"n_layers": n}
    if cfg.n_enc_layers:
        out["n_enc_layers"] = min(cfg.n_enc_layers, n)
    return out


def model_flops(cfg, spec) -> float:
    """The products a step needs: 6·N·D tokens for train (×3 for bwd
    already in 6ND); 2·N per token forward-only for decode; a prefill
    takes the logits of its last position only.  N is the active
    parameters without the input table (a lookup does no products), the
    N of PERF.md's MFU."""
    table = cfg.vocab * cfg.d_model
    n_body = cfg.active_param_count() - table * (
        1 if cfg.tie_embeddings else 2)
    tokens = spec.seq_len * spec.global_batch
    if spec.kind == "train":
        return 6.0 * (n_body + table) * tokens
    if spec.kind == "prefill":
        return 2.0 * n_body * tokens + 2.0 * table * spec.global_batch
    return 2.0 * (n_body + table) * spec.global_batch


def lower_cell(arch_id: str, shape_name: str, mesh, *,
               microbatch: int | None = None,
               remat_policy: str = "dots",
               moments: str = "fp32",
               sp: bool = True,
               seq_fallback: bool = False,
               moe_grouped: bool = False,
               param_dtype=None,
               rules_overrides: dict | None = None,
               serve_params: str = "train",
               donate: bool = True,
               n_layers: int | None = None) -> dict:
    """Trace one cell on ``mesh``; return the dry-run record.

    ``donate`` is accepted for the reference's signature: the port's
    steps always update their state in place.  ``moe_grouped`` picks the
    MoE's grouped dispatch (one token group per data-parallel shard), as
    the reference's does.  ``n_layers`` cuts the depth
    (:func:`cut_depth`; the record says so under ``n_layers``); None
    keeps the config's."""
    # imported here: importing torch's debug package sets an environment
    # variable (TORCHINDUCTOR_CACHE_DIR), which no import of the port may
    from torch.distributed.tensor.debug import CommDebugMode
    extra = {}
    if param_dtype is not None:
        extra["param_dtype"] = param_dtype
    base = get_config(arch_id)
    if n_layers is not None:
        extra.update(cut_depth(base, n_layers))
    cfg = dataclasses.replace(base,
                              remat_policy=remat_policy,
                              seq_shard_fallback=seq_fallback,
                              moe_grouped=moe_grouped,
                              use_flash=False,
                              **extra)
    spec = input_specs(arch_id, shape_name, cfg=cfg)
    overrides = dict(rules_overrides or {})
    if not sp:
        overrides["seq_sp"] = None
    rules = make_rules(mesh, overrides)
    n_dev = mesh.size()
    t0 = time.time()

    with fake_tensors(), use_rules(rules), implicit_replication():
        model = build_model(cfg, mesh.device_type,
                            training=spec.kind == "train")
        params = model.init(torch.Generator(mesh.device_type))
        distribute_params(params, mesh, "train" if spec.kind == "train"
                          else serve_params)
        n_chunks = (microbatch or 1) if spec.kind == "train" else 1
        batch = [_placed_batch(spec.batch, mesh, n_chunks)
                 for _ in range(n_chunks)]
        if spec.kind == "train":
            state = init_opt_state(params, moments)
            step = make_train_step(model, AdamWConfig(moments_dtype=moments),
                                   microbatch=n_chunks)
            state_leaves = _state_leaves(params) + _state_leaves(state)

            def run():
                return step(params, state, batch)[2]
        elif spec.kind == "prefill":
            state_leaves = _state_leaves(params)

            def run():
                with torch.no_grad():
                    return model.prefill(params, batch[0], spec.seq_len)
        else:
            cache = model.init_cache(spec.global_batch, spec.seq_len)
            serve = make_serve_step(model)
            state_leaves = _state_leaves(params) + _state_leaves(cache)

            def run():
                with torch.no_grad():
                    return serve(params, batch[0]["token"], cache)
        t_lower = time.time() - t0
        argument_bytes = _local_bytes(state_leaves) + _local_bytes(batch)
        # the counter is entered last, so it sees each DTensor op first
        with CommDebugMode() as comm, \
                _PeakMemory(torch.device(mesh.device_type)) as mem, \
                Counter() as counts:
            try:
                out = run()
            except Exception as e:
                raise RuntimeError(f"{type(e).__name__} in DTensor's "
                                   f"{counts.last_dtensor_op}: {e}") from e
        t_compile = time.time() - t0 - t_lower
        inputs = {id(t) for t in state_leaves}
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        output_bytes = _local_bytes([t for t in outs if id(t) not in inputs])
        alias_bytes = _local_bytes(state_leaves) if donate else 0
        state_bytes = _global_bytes(state_leaves)
        del out, outs

    n_active = cfg.active_param_count()
    roof = analyse(counts, n_devices=n_dev,
                   model_flops=model_flops(cfg, spec))
    return {
        "arch": arch_id, "shape": shape_name, "kind": spec.kind,
        "mesh": list(mesh.shape), "axes": list(mesh_axes(mesh)),
        "n_devices": n_dev,
        "seq_len": spec.seq_len, "global_batch": spec.global_batch,
        "n_layers": cfg.n_layers,
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "state_bytes_global": state_bytes,
        "state_bytes_per_device": state_bytes // n_dev,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": mem.peak,
            "alias_bytes": alias_bytes,
            "peak_estimate": argument_bytes + mem.peak,
        },
        "cost": {"flops": counts.flops, "bytes accessed": counts.bytes},
        "comm_counts": {str(k): v for k, v in
                        comm.get_comm_counts().items()},
        "roofline": roof.to_json(),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
    }


def run_cells(cells, meshes: list[str], out_dir: str, force: bool,
              microbatch: int | None = None,
              n_layers: int | None = None,
              moe_grouped: bool = False) -> list[dict]:
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for mesh_name in meshes:
        with production_mesh(multi_pod=(mesh_name == "pod2")) as mesh:
            results += _run_on(mesh, mesh_name, cells, out_dir, force,
                               microbatch, n_layers, moe_grouped)
    return results


def ladder(arch: str, shape: str, mesh, microbatch: int | None = None,
           n_layers: int | None = None, moe_grouped: bool = False) -> dict:
    """One cell traced down the memory ladder until its peak fits the
    card: (1) more grad accumulation while the per-chunk batch still
    divides the FULL dp extent (pod x data), (2) tighter remat, (3)
    8-bit moments.  The record carries the knobs it ended with."""
    _, gb, kind = SHAPES[shape]
    mb = microbatch if kind == "train" else None
    if mb is None and kind == "train":
        mb = 8
    remat, moments = "dots", "fp32"
    rec = lower_cell(arch, shape, mesh, microbatch=mb, n_layers=n_layers,
                     moe_grouped=moe_grouped)
    sizes = mesh_axes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    while (kind == "train"
           and rec["memory"]["peak_estimate"] > HBM_PER_CHIP):
        if (gb // (mb * 2)) % dp == 0:
            mb *= 2
        elif remat == "dots":
            remat = "nothing"
        elif moments == "fp32":
            moments = "int8"
        else:
            break
        print(f"  over HBM "
              f"({rec['memory']['peak_estimate'] / 2**30:.1f}"
              f"GiB); retry microbatch={mb} remat={remat} "
              f"moments={moments}", flush=True)
        rec = lower_cell(arch, shape, mesh, microbatch=mb,
                         remat_policy=remat, moments=moments,
                         n_layers=n_layers, moe_grouped=moe_grouped)
    rec["microbatch"] = mb
    rec["remat_policy"] = remat
    rec["moments"] = moments
    return rec


def _run_on(mesh, mesh_name: str, cells, out_dir: str, force: bool,
            microbatch: int | None, n_layers: int | None,
            moe_grouped: bool) -> list[dict]:
    results = []
    for arch, shape, ok, why in cells:
        tag = f"{arch}__{shape}__{mesh_name}" + (
            "__grouped" if moe_grouped else "")
        path = os.path.join(out_dir, tag + ".json")
        if not ok:
            print(f"SKIP {tag}: {why}")
            continue
        if os.path.exists(path) and not force:
            with open(path) as fh:
                results.append(json.load(fh))
            print(f"CACHED {tag}")
            continue
        print(f"LOWER {tag} ...", flush=True)
        try:
            rec = ladder(arch, shape, mesh, microbatch=microbatch,
                         n_layers=n_layers, moe_grouped=moe_grouped)
            rec["tag"] = tag
            with open(path, "w") as fh:
                json.dump(rec, fh, indent=1)
            results.append(rec)
            r = rec["roofline"]
            print(f"  OK trace={rec['compile_s']}s "
                  f"mem/dev={rec['memory']['peak_estimate'] / 2**30:.2f}GiB "
                  f"compute={r['compute_s'] * 1e3:.1f}ms "
                  f"mem={r['memory_s'] * 1e3:.1f}ms "
                  f"coll={r['collective_s'] * 1e3:.1f}ms "
                  f"-> {r['bottleneck']}", flush=True)
        except Exception as e:     # noqa: BLE001 — one cell's failure
            print(f"  FAIL {tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
            with open(os.path.join(out_dir, tag + ".FAIL"), "w") as fh:
                fh.write(traceback.format_exc())
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "pod2", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut every cell's depth (cut_depth); each traced "
                         "layer costs seconds of host time")
    ap.add_argument("--moe-grouped", action="store_true",
                    help="the MoE's grouped dispatch (tags end __grouped)")
    args = ap.parse_args()

    if args.arch in (None, "all") and args.shape in (None, "all"):
        cells = all_cells(include_skipped=True)
    else:
        archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
        shapes = list(SHAPES) if args.shape in (None, "all") \
            else [args.shape]
        cells = []
        for a in archs:
            for s in shapes:
                ok, why = cell_supported(a, s)
                cells.append((a, s, ok, why))
    meshes = ["pod", "pod2"] if args.mesh == "both" else [args.mesh]
    results = run_cells(cells, meshes, args.out, args.force,
                        microbatch=args.microbatch, n_layers=args.n_layers,
                        moe_grouped=args.moe_grouped)
    print(f"\n{len(results)} cells recorded in {args.out}")


if __name__ == "__main__":
    main()
