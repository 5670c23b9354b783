"""``models.adam_train``'s step body and CUDA-graph path against the loop it
replaced.

``adam_train`` runs ``models._AdamStep``: static buffers updated in place,
the bias corrections and step mask read at a device counter.  Eagerly on
the CPU (and on a card below ``ADAM_GRAPH_MIN_STEPS``); on a card it runs
one step eagerly and replays a captured step for the rest.  ``_loop_adam``
below is the out-of-place loop that ``adam_train`` ran before the step body
existed, which ``test_torch_automl.py`` held to the reference.  The CPU
cases hold the step body to it bit for bit: every gradient family, ``lr``
as a float and as a per-trial tensor, with and without the per-trial step
mask, with the plain loss and the padded loss of a merge.  The ``cuda``
cases hold the graph path to it on the card, bit for bit at the benchmark
cells' shapes, with no host sync, and check the ``graph_steps`` count.

This file imports no JAX, so the ``cuda`` cases run on a card machine:
``python -m pytest -q -m cuda tests/test_torch_adam_graph.py`` with ``src``
on the path.
"""
import pytest
import torch

import repro_torch.automl.models as TM
from repro_torch.obs import trace

STEPS = 9


def _loop_adam(loss_fn, params0, lr, epochs, n_steps=None):
    """Full-batch Adam as an out-of-place loop, op for op the reference's."""
    flat = [p.detach().clone() for p in TM._leaves(params0)]
    dev = flat[0].device
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    masked = isinstance(n_steps, torch.Tensor)
    steps = epochs if n_steps is None or masked else min(epochs, int(n_steps))
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.full((), 0.9, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.full((), 0.999, dtype=torch.float32, device=dev), t)
    lrs = [TM._per_trial(lr, x.ndim) for x in flat]
    if masked:
        active = torch.arange(steps, device=dev)[:, None] < n_steps[None, :]
    for i in range(steps):
        leaves = [x.requires_grad_(True) for x in flat]
        loss = loss_fn(TM._rebuild(params0, leaves))
        grads = torch.autograd.grad(loss.sum() if loss.ndim else loss, leaves)
        with torch.no_grad():
            m_n = [0.9 * mi + 0.1 * gi for mi, gi in zip(m, grads)]
            v_n = [0.999 * vi + 0.001 * gi ** 2 for vi, gi in zip(v, grads)]
            flat_n = [fi - li * (mi / bc1[i]) / (torch.sqrt(vi / bc2[i]) + 1e-8)
                      for fi, li, mi, vi in zip(flat, lrs, m_n, v_n)]
            if masked:
                def sel(new, old):
                    return [torch.where(TM._per_trial(active[i], o.ndim), a, o)
                            for a, o in zip(new, old)]
                flat, m, v = sel(flat_n, flat), sel(m_n, m), sel(v_n, v)
            else:
                flat, m, v = flat_n, m_n, v_n
    return TM._rebuild(params0, [x.detach() for x in flat])


def _problem(family, depth, T, N, d, c, width, lr_per_trial, masked, steps, device,
             padded=False):
    """Inputs, initial params, HPs and the loss of one stack of ``T`` trials.
    ``padded``: the trials of a merge of two tables, as ``batched`` builds
    it: odd trials' table has fewer rows, features and classes, zero-padded,
    with the row weights and class mask of ``models.masked_loss``."""
    g = torch.Generator().manual_seed(T * 1000 + N + d)
    X = torch.randn(T, N, d, generator=g)
    y = torch.randint(0, c, (T, N), generator=g)
    fam = TM.FAMILIES[family]
    if family == "mlp":
        trials = [fam.init(g, d, c, {"width": width, "depth": depth}, "cpu") for _ in range(T)]
        p0 = TM._rebuild(trials[0], [torch.stack(xs).to(device)
                                     for xs in zip(*map(TM._leaves, trials))])
    else:
        p0 = {k: (torch.randn((T,) + x.shape, generator=g) * 0.1).to(device)
              for k, x in fam.init(None, d, c, {}, "cpu").items()}
    hp = {"l2": (torch.tensor([1e-4, 1e-2, 0.0])[torch.arange(T) % 3]).to(device)}
    lr = (torch.tensor([0.3, 0.1, 0.03, 0.01])[torch.arange(T) % 4].to(device)
          if lr_per_trial else 0.05)
    n_steps = ((torch.arange(T) % steps + 1).to(device) if masked else None)
    if not padded:
        X, y = X.to(device), y.to(device)

        def loss_fn(p):
            return fam.loss(p, X, y, c, hp)
        return loss_fn, p0, lr, n_steps
    small = torch.arange(T) % 2 == 1                     # the smaller table's trials
    rows = torch.arange(N) < (N * 3) // 4
    w = torch.where(small[:, None], rows[None, :], True).to(torch.float32)
    X = torch.where(small[:, None, None] & ~(rows[None, :, None] & (torch.arange(d) < d - 2)),
                    0.0, X)
    y = torch.where(small[:, None], y % (c - 1), y) * w.long()
    cm = torch.where(small[:, None] & (torch.arange(c) == c - 1), TM.CLASS_MASK_NEG, 0.0)
    X, y, w, cm = X.to(device), y.to(device), w.to(device), cm.to(device)

    def loss_fn(p):
        return TM.masked_loss(family, p, X, y, w, cm, c, hp)
    return loss_fn, p0, lr, n_steps


FAMILIES = [("logreg", 0), ("linear_svm", 0), ("mlp", 1), ("mlp", 2)]


@pytest.mark.parametrize("masked", [False, True], ids=["all_steps", "step_mask"])
@pytest.mark.parametrize("lr_per_trial", [False, True], ids=["lr_float", "lr_per_trial"])
@pytest.mark.parametrize("family,depth", FAMILIES, ids=["logreg", "svm", "mlp1", "mlp2"])
def test_graph_step_body_equals_the_eager_loop_on_cpu(family, depth, lr_per_trial, masked):
    loss_fn, p0, lr, n_steps = _problem(family, depth, 3, 40, 5, 3, 8, lr_per_trial, masked,
                                        STEPS, "cpu")
    want = TM._leaves(_loop_adam(loss_fn, p0, lr, STEPS, n_steps))
    flat = [p.detach().clone() for p in TM._leaves(p0)]
    t = torch.arange(1, STEPS + 1, dtype=torch.float32)
    bc1 = 1 - torch.pow(torch.full((), 0.9, dtype=torch.float32), t)
    bc2 = 1 - torch.pow(torch.full((), 0.999, dtype=torch.float32), t)
    active = torch.arange(STEPS)[:, None] < n_steps[None, :] if masked else None
    step = TM._AdamStep(loss_fn, p0, flat, [TM._per_trial(lr, x.ndim) for x in flat],
                        bc1, bc2, active)
    for _ in range(STEPS):
        step()
    assert int(step.k) == STEPS
    assert all(torch.equal(a, b.detach()) for a, b in zip(want, flat))
    got = TM._leaves(TM.adam_train(loss_fn, p0, lr, STEPS, n_steps))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not all(torch.equal(a, b) for a, b in zip(want, TM._leaves(p0)))


@pytest.mark.parametrize("masked", [False, True], ids=["all_steps", "step_mask"])
@pytest.mark.parametrize("family,depth", FAMILIES, ids=["logreg", "svm", "mlp1", "mlp2"])
def test_masked_loss_step_equals_the_eager_loop_on_cpu(family, depth, masked):
    """The padded loss of a merge of tables of different shapes."""
    loss_fn, p0, lr, n_steps = _problem(family, depth, 4, 40, 6, 3, 8, True, masked,
                                        STEPS, "cpu", padded=True)
    want = TM._leaves(_loop_adam(loss_fn, p0, lr, STEPS, n_steps))
    got = TM._leaves(TM.adam_train(loss_fn, p0, lr, STEPS, n_steps))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert all(torch.isfinite(a).all() for a in got)


def test_cpu_runs_the_eager_loop_and_counts_no_graph_steps(monkeypatch):
    def no_graph(*args):
        raise AssertionError("the graph path ran on the CPU")
    monkeypatch.setattr(TM, "_adam_graphed", no_graph)
    loss_fn, p0, lr, _ = _problem("logreg", 0, 2, 30, 4, 2, 8, False, False, STEPS, "cpu")
    sink = []
    with trace.collect(sink):
        with trace.span(None, None, "automl.rung.issue", graph_steps=0) as sp:
            TM.adam_train(loss_fn, p0, lr, max(STEPS, TM.ADAM_GRAPH_MIN_STEPS))
    assert sp["attrs"] == {"graph_steps": 0}


@pytest.mark.parametrize("attrs,want", [
    ({"graph_steps": 0}, {"graph_steps": 7}),
    ({"graph_steps": 5, "adam_steps": 9}, {"graph_steps": 12, "adam_steps": 9}),
    ({"worker": 0}, {"worker": 0}),
    ({}, {}),
], ids=["issue_span", "issue_span_counted_before", "worker_leg", "plain_span"])
def test_graph_steps_land_only_on_a_span_opened_for_them(attrs, want):
    """Only a span opened with ``graph_steps`` takes the count; a service
    worker's leg, or any other span, keeps its attrs."""
    sink = []
    with trace.span(sink, "t0", "leg", **attrs) as sp:
        TM._count_graph_steps(7)
    assert sp["attrs"] == want
    TM._count_graph_steps(7)          # no open span: nothing to count on


# The benchmark cells' shapes: the sub-AutoML stacked on D1's 322-row subset
# (257 training rows, 5 features, MLP widths padded to 128), the fine-tune
# and Full-AutoML over D1's 83,123 training rows (22 features), trial by
# trial, and Full-AutoML's MLP trials over D6's 11,145 (8 features, 3 classes).
CELL_SHAPES = [
    ("logreg", 0, 8, 257, 5, 2, 0), ("linear_svm", 0, 6, 257, 5, 2, 0),
    ("mlp", 1, 6, 257, 5, 2, 128), ("mlp", 2, 6, 257, 5, 2, 128),
    ("logreg", 0, 3, 83123, 22, 2, 0), ("linear_svm", 0, 2, 83123, 22, 2, 0),
    ("mlp", 1, 2, 83123, 22, 2, 64), ("mlp", 2, 1, 83123, 22, 2, 128),
    ("logreg", 0, 3, 11145, 8, 3, 0), ("mlp", 1, 2, 11145, 8, 3, 128),
    ("mlp", 2, 2, 11145, 8, 3, 32),
]
# Merges of two tables of different shapes, as the service's megabatches
# pad them: D6's 11,145 rows and 3 classes with a table of 3/4 its rows,
# two features fewer and one class fewer, every gradient family.
MERGE_SHAPES = [
    ("logreg", 0, 4, 11145, 8, 3, 0), ("linear_svm", 0, 4, 11145, 8, 3, 0),
    ("mlp", 1, 4, 11145, 8, 3, 128), ("mlp", 2, 4, 11145, 8, 3, 32),
]


def _graph_against_loop(shape, masked, padded):
    """The graph path against ``_loop_adam`` on the card, under sync-debug
    "error", inside an issue span and a service worker's leg."""
    family, depth, T, N, d, c, width = shape
    steps = 20
    loss_fn, p0, lr, n_steps = _problem(family, depth, T, N, d, c, width, True, masked,
                                        steps, "cuda", padded=padded)
    want = _loop_adam(loss_fn, p0, lr, steps, n_steps)
    sink = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.collect(sink):
            with trace.span(None, None, "automl.rung.issue", graph_steps=0) as sp:
                got = TM.adam_train(loss_fn, p0, lr, steps, n_steps)
            with trace.span(sink, "t0", "eval", worker=0) as leg:
                again = TM.adam_train(loss_fn, p0, lr, steps, n_steps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sp["attrs"]["graph_steps"] == steps - 1
    assert leg["attrs"] == {"worker": 0}
    pairs = list(zip(TM._leaves(want), TM._leaves(got)))
    assert all(torch.equal(a, b) for a, b in pairs), [(a - b).abs().max().item() for a, b in pairs]
    assert all(torch.equal(a, b) for a, b in zip(TM._leaves(got), TM._leaves(again)))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all_steps", "step_mask"])
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=[f"{f}{dp or ''}-T{T}-N{N}" for f, dp, T, N, *_ in CELL_SHAPES])
def test_graph_path_equals_the_eager_loop_on_card(shape, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path runs only there")
    _graph_against_loop(shape, masked, padded=False)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all_steps", "step_mask"])
@pytest.mark.parametrize("shape", MERGE_SHAPES,
                         ids=[f"{f}{dp or ''}-T{T}-N{N}" for f, dp, T, N, *_ in MERGE_SHAPES])
def test_graph_path_with_the_masked_loss_on_card(shape, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph path runs only there")
    _graph_against_loop(shape, masked, padded=True)
