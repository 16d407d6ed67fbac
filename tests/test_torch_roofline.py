"""The port's roofline counter and analysis (roofline/) against the JAX
package's HLO cost model on the same programs, and the collective bytes
of known redistributions on a fake mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard

from repro.roofline.hlo_cost import analyse_hlo

from repro_torch.kernels import tally
from repro_torch.kernels.correction.ops import correct
from repro_torch.launch.mesh import fake_process_group, fake_tensors
from repro_torch.models.sharding import distribute
from repro_torch.roofline import (HBM_BW, ICI_BW_EFF, PEAK_FLOPS, Counter,
                                  analyse)
from repro_torch.roofline.introspect import collective_profile
from repro_torch.roofline.report import summary_stats


@pytest.fixture(scope="module", autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def test_loop_flops_equal_reference_scan():
    L, B, D = 5, 8, 32

    def f(x, ws):
        def body(x, w):
            return jnp.dot(x, w).astype(x.dtype), None
        return jax.lax.scan(body, x, ws)[0]

    c = jax.jit(f).lower(
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, D, D), jnp.float32)).compile()
    want = analyse_hlo(c.as_text())["flops"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(L, D, D)).astype(np.float32))
    with Counter() as cnt:
        for w in ws:
            x = x @ w
    assert cnt.flops == pytest.approx(want, rel=0.01)
    assert cnt.flops == pytest.approx(2.0 * L * B * D * D, rel=0.01)


def test_nested_loop_flops_equal_reference_scans():
    L, M, B, D = 3, 4, 4, 16

    def f(x, ws):
        def outer(x, wrow):
            def inner(x, w):
                return jnp.dot(x, w).astype(x.dtype), None
            return jax.lax.scan(inner, x, wrow)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    c = jax.jit(f).lower(
        jax.ShapeDtypeStruct((B, D), jnp.float32),
        jax.ShapeDtypeStruct((L, M, D, D), jnp.float32)).compile()
    want = analyse_hlo(c.as_text())["flops"]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(L, M, D, D)).astype(np.float32))
    with Counter() as cnt:
        for row in ws:
            for w in row:
                x = x @ w
    assert cnt.flops == pytest.approx(want, rel=0.01)


def test_bytes_counted_views_not():
    x = torch.ones(64, 64)
    with Counter() as cnt:
        y = x * 2.0
    assert cnt.bytes >= 64 * 64 * 4
    assert cnt.bytes == 2 * y.numel() * 4
    with Counter() as views:
        x.reshape(-1)[:10].view(2, 5).t().unsqueeze(0)
    assert views.bytes == 0
    buf = torch.zeros(100, 8)
    upd = torch.ones(3, 8)
    with Counter() as partial:
        buf.index_put_((torch.tensor([1, 5, 7]),), upd, accumulate=True)
        buf[10:12] = 1.0
    # an in-place update counts its update slice, not the whole buffer
    idx_bytes = 2 * 3 * 8                 # the int64 index tensor's write
    assert partial.bytes < 2 * buf.numel() * 4
    assert partial.bytes >= 2 * (upd.numel() * 4 + 2 * 8 * 4) - idx_bytes


def test_kernel_work_comes_from_cost_not_its_plain_ops():
    raw = torch.full((4, 8, 16), 500.0)
    dark = torch.full((8, 16), 96.0)
    flat = torch.full((8, 16), 40000.0)
    with Counter() as cnt:
        correct(raw, dark, flat, use_pallas=False)
    with tally.tally(costs=True) as t:
        correct(raw, dark, flat, use_pallas=False)
    assert (cnt.flops, cnt.bytes) == (t.flops, t.bytes)
    assert cnt.bytes > 0


def test_analyse_terms_and_bottleneck():
    counts = {"flops": PEAK_FLOPS, "bytes": HBM_BW * 2,
              "collective_bytes": ICI_BW_EFF * 0.5,
              "coll_detail": {"all-reduce": int(ICI_BW_EFF * 0.25)}}
    r = analyse(counts, n_devices=4, model_flops=PEAK_FLOPS * 2)
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 2.0) < 1e-6
    assert abs(r.collective_s - 0.5) < 1e-6
    assert r.bottleneck == "memory"
    assert 0 < r.useful_ratio <= 1.0
    # the card: H100 SXM's bf16 peak and HBM3 rate
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)


def test_collective_bytes_of_known_redistributions():
    """Output-shape bytes of each collective; an all-reduce weighs 2×."""
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with fake_tensors():
            x = distribute(torch.zeros(8, 16), mesh, [Shard(0), Replicate()])
            p = torch.distributed.tensor.DTensor.from_local(
                torch.zeros(8, 16), mesh, [Partial(), Replicate()],
                run_check=False)
            with Counter() as cnt:
                x.redistribute(mesh, [Replicate(), Replicate()])   # AG
                x.redistribute(mesh, [Shard(1), Replicate()])      # A2A
                p.redistribute(mesh, [Replicate(), Replicate()])   # AR
                p.redistribute(mesh, [Shard(0), Replicate()])      # RS
    assert cnt.coll == {"all-gather": 8 * 16 * 4, "all-to-all": 8 * 8 * 4,
                        "all-reduce": 8 * 16 * 4,
                        "reduce-scatter": 4 * 16 * 4,
                        "collective-permute": 0}
    assert cnt.n_collectives == 4
    assert cnt.collective_bytes == (8 * 16 * 4 + 8 * 8 * 4 +
                                    2 * 8 * 16 * 4 + 4 * 16 * 4)
    top = dict(collective_profile(cnt))
    assert top["all-reduce float32[8,16]"] == 2 * 8 * 16 * 4
    assert top["all-to-all float32[8,8]"] == 8 * 8 * 4


def test_sharded_matmul_counts_its_local_quarter():
    m, k, n = 64, 32, 48
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with fake_tensors():
            a = distribute(torch.zeros(m, k), mesh, [Shard(0), Replicate()])
            b = distribute(torch.zeros(k, n), mesh, [Replicate(), Shard(1)])
            with Counter() as cnt:
                c = a @ b
            assert tuple(c.to_local().shape) == (m // 2, n // 2)
    assert cnt.flops == 2.0 * m * k * n / 4
    assert cnt.n_collectives == 0


def test_summary_stats_flags_cells_over_the_card():
    cells = [{"memory": {"peak_estimate": 79e9},
              "roofline": {"bottleneck": "compute"}},
             {"memory": {"peak_estimate": 81e9},
              "roofline": {"bottleneck": "collective"}}]
    s = summary_stats(cells)
    assert s["over_hbm"] == 1
    assert s["bottlenecks"] == {"compute": 1, "collective": 1}
