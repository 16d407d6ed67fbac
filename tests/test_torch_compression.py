"""int8 gradient compression (distributed/compression.py) against the JAX
package's, bit for bit on the same numpy inputs."""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.distributed import compressed_psum as jax_psum  # noqa: E402
from repro.distributed import quantise_int8 as jax_quantise  # noqa: E402

from repro_torch.distributed import (compressed_psum,  # noqa: E402
                                     dequantise_int8, quantise_int8,
                                     quantise_tree)


@pytest.fixture(scope="module", autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@given(st.integers(1, 3000), st.floats(0.01, 100.0))
@settings(max_examples=30, deadline=None)
def test_int8_codes_and_scales_equal_reference(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    q, s = quantise_int8(torch.from_numpy(x))
    jq, js = jax_quantise(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # error bounded by half a quantisation step per block
    xr = dequantise_int8(q, s, n, (n,)).numpy()
    blocks = np.pad(x, (0, (-n) % 256)).reshape(-1, 256)
    steps = np.abs(blocks).max(1) / 127.0
    err = np.pad(np.abs(xr - x), (0, (-n) % 256)).reshape(-1, 256)
    assert np.all(err.max(1) <= steps * 0.51 + 1e-7)


def test_error_feedback_reduces_bias(rng):
    g = {"w": torch.from_numpy(rng.normal(size=(512,)).astype(np.float32))}
    res = None
    acc = np.zeros(512)
    for _ in range(50):
        _, deq, res = quantise_tree(g, res)
        acc += deq["w"].numpy()
    # accumulated dequantised grads converge to 50x true grad
    np.testing.assert_allclose(acc / 50, g["w"].numpy(), atol=2e-3)


def test_quantise_tree_takes_a_module_grads(rng):
    lin = torch.nn.Linear(8, 4)
    lin.weight.grad = torch.from_numpy(
        rng.normal(size=(4, 8)).astype(np.float32))
    lin.bias.grad = torch.zeros(4)
    qs, deq, res = quantise_tree(lin)
    assert set(qs) == {"weight", "bias"}
    np.testing.assert_allclose(deq["weight"] + res["weight"],
                               lin.weight.grad, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_one_rank_equals_reference():
    x = np.random.default_rng(0).normal(size=(300,)).astype(np.float32)
    jmesh = jax.make_mesh((1,), ("pod",),
                          axis_types=(jax.sharding.AxisType.Auto,))
    want = np.asarray(jax_psum(jnp.asarray(x), jmesh, axis="pod"))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        got = compressed_psum(torch.from_numpy(x), mesh, axis="pod").numpy()
        # no `data` axis on this mesh: the identity, as the reference's
        t = torch.from_numpy(x)
        assert compressed_psum(t, mesh, axis="data") is t
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(got, x, atol=2e-2)
