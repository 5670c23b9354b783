"""The port's cost counters (``repro_torch.launch.costs``), the counterpart
of the JAX package's ``launch/hlo_costs.py``, on the cases of
``tests/test_hlo_costs.py``: a loop of matmuls, nested loops, the gradient's
factor and the bytes; then what only a trace over DTensors has: one
device's product counted once, and the collectives per class with their
bytes on the fake process group.  Counts are exact (tolerance: none), the
reference's ``analyze_hlo`` where both run.
"""
import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch.hlo_costs import analyze_hlo
from repro_torch.launch.costs import COLLECTIVES, CostCounter, trace_costs
from repro_torch.launch.mesh import fake_mesh


def _count(fn, *args):
    with CostCounter() as cc:
        fn(*args)
    return cc


def _hlo_flops(f, *args):
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text()).flops


def test_loop_of_matmuls_flops_exact():
    L, M, K = 7, 128, 256
    ws, x = torch.zeros((L, K, K)), torch.zeros((M, K))

    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    def jf(ws, x):
        y, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
        return y.sum()

    expected = L * 2 * M * K * K
    assert _count(f, ws, x).flops == expected
    assert _hlo_flops(jf, jnp.zeros((L, K, K)), jnp.zeros((M, K))) == expected


def test_nested_loops_flops():
    Lo, Li, M = 3, 5, 32
    ws, x = torch.zeros((Lo, Li, M, M)), torch.zeros((M, M))

    def f(ws, x):
        for wo in ws:
            for wi in wo:
                x = x @ wi
        return x.sum()

    assert _count(f, ws, x).flops == Lo * Li * 2 * M ** 3


def test_grad_flops_factor():
    M = 64
    w = torch.zeros((M, M), requires_grad=True)
    x = torch.zeros((M, M), requires_grad=True)

    def f(w, x):
        torch.tanh(x @ w).sum().backward()

    # the forward product and the two of the backward, as the reference counts
    assert _count(f, w, x).flops == 3 * 2 * M ** 3
    jf = jax.grad(lambda w, x: jnp.tanh(x @ w).sum(), argnums=(0, 1))
    assert _hlo_flops(jf, jnp.zeros((M, M)), jnp.zeros((M, M))) == 3 * 2 * M ** 3


def test_bytes_positive_and_sane():
    x = torch.zeros((256, 256))
    cc = _count(lambda x: (x @ x).sum(), x)
    assert cc.flops == 2 * 256 ** 3
    # x read twice by the product, its output written and read by the sum
    assert cc.bytes >= 2 * 256 * 256 * 4 + 2 * 256 * 256 * 4


def test_views_move_no_bytes():
    x = torch.zeros((64, 64))
    assert _count(lambda x: x.t()[:, :10].unsqueeze(0).expand(3, 64, 10), x).bytes == 0


def test_dtensor_product_counted_once_per_device():
    """(8, 64) x (64, 128), x sharded over data=2 on rows, w over model=4 on
    columns: one device multiplies (4, 64) x (64, 32), 16,384 FLOPs
    (``FlopCounterMode`` also counts the global product's 131,072 where
    DTensor's propagation runs it on the trace's fake tensors)."""
    with fake_mesh((2, 4), ("data", "model")) as mesh, FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        _, costs = trace_costs(lambda a, b: a @ b, x, w)
        _, again = trace_costs(lambda a, b: a @ b, x, w)
    assert costs.flops == again.flops == 2 * 4 * 64 * 32
    assert costs.collective_bytes == 0
    assert costs.argument_bytes == (4 * 64 + 64 * 32) * 4
    assert costs.peak_bytes >= costs.argument_bytes + 4 * 32 * 4


def test_collective_classes_and_bytes_on_the_fake_group():
    """Each redistribution is one collective of its class, its bytes the
    output's with the reference's ring factors (k = 4 over model).  A CUDA
    mesh on the fake process group, meta tensors (as the dry-run traces
    without a card)."""
    empty = lambda *shape: torch.empty(*shape, device="meta")   # noqa: E731
    with fake_mesh((2, 4), ("data", "model")) as mesh, FakeTensorMode():
        rows = DTensor.from_local(empty(16, 64), mesh, [Replicate(), Shard(0)],
                                  run_check=False)
        n = 64 * 64 * 4                                   # the (64, 64) float32 output
        _, c = trace_costs(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), rows)
        assert c.collectives["all-gather"] == {"count": 1, "bytes": n * 3 / 4}
        part = rows.redistribute(mesh, [Replicate(), Replicate()])
        summed = DTensor.from_local(part.to_local(), mesh, [Replicate(), Shard(0)],
                                    run_check=False).sum(0)    # partial over model
        _, c = trace_costs(lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), summed)
        assert c.collectives["all-reduce"] == {"count": 1, "bytes": 2 * 64 * 4 * 3 / 4}
        _, c = trace_costs(lambda t: t.redistribute(mesh, [Replicate(), Shard(0)]), summed)
        assert c.collectives["reduce-scatter"] == {"count": 1, "bytes": 16 * 4 * 3 / 4}
        cols = DTensor.from_local(empty(16, 64), mesh, [Replicate(), Shard(0)],
                                  run_check=False)
        _, c = trace_costs(lambda t: t.redistribute(mesh, [Replicate(), Shard(1)]), cols)
        assert c.collectives["all-to-all"]["count"] == 1
        assert set(c.collectives) == set(COLLECTIVES)
        for kind in ("all-gather", "all-reduce", "reduce-scatter"):
            assert c.collectives[kind]["count"] == 0
