"""The port's ``FaultTolerantLoop`` (``distributed/fault.py``) on the CPU,
after the reference's ``tests/test_fault.py:147-174``, and held to the
reference's loop on the same steps.

Tolerances: the restarted run equals the uninterrupted one exactly (the
same float32 operations from the same restored state); the port's run
equals the reference's within 1e-6 relative.  A restart from a train
step's checkpoint (a ``TrainState`` over ``Params``) reproduces the
uninterrupted training run's losses exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.fault import FaultTolerantLoop as JLoop
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.device import make_generator
from repro_torch.distributed.fault import FaultTolerantLoop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from _torch_port import port_config


def _batch(step):
    return np.random.default_rng(step).normal(0, 1, (4,)).astype(np.float32)


def _step_fn(state, batch):
    new = {"x": state["x"] * 0.9 + batch.sum(), "n": state["n"] + 1}
    return new, {"x": new["x"]}


def _make_loop(path, reference=False):
    if reference:
        return JLoop(_step_fn, lambda s: jnp.asarray(_batch(s)), path, ckpt_every=3)
    return FaultTolerantLoop(_step_fn, lambda s: torch.as_tensor(_batch(s)), path, ckpt_every=3)


def _init():
    return {"x": torch.tensor(1.0), "n": torch.tensor(0, dtype=torch.int32)}


def test_restart_reproduces_uninterrupted_run(tmp_path):
    golden, _ = _make_loop(tmp_path / "golden").run(_init(), 10)

    loop = _make_loop(tmp_path / "crashy")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        loop.run(_init(), 10, simulate_failure_at=7)
    resumed, metrics = _make_loop(tmp_path / "crashy").run(_init(), 10)

    assert int(resumed["n"]) == int(golden["n"]) == 10
    assert float(resumed["x"]) == float(golden["x"])
    assert resumed["x"].dtype == torch.float32 and resumed["n"].dtype == torch.int32
    assert float(metrics["x"]) == float(resumed["x"])
    ref, _ = _make_loop(tmp_path / "reference", reference=True).run(
        {"x": jnp.float32(1.0), "n": jnp.int32(0)}, 10)
    assert float(golden["x"]) == pytest.approx(float(ref["x"]), rel=1e-6)


def test_restart_skips_completed_steps(tmp_path):
    loop = _make_loop(tmp_path)
    loop.run(_init(), 6)
    calls = []
    loop2 = _make_loop(tmp_path)
    orig = loop2.step_fn

    def counting(state, batch):
        calls.append(1)
        return orig(state, batch)

    loop2.step_fn = counting
    state, _ = loop2.run(_init(), 10)
    assert len(calls) == 4, "only steps 6..9 re-run after restore"
    assert int(state["n"]) == 10


def test_restart_of_a_train_step_reproduces_its_losses(tmp_path):
    """The loop over the port's train step: a TrainState of Params and
    AdamW state restored from its checkpoint continues exactly as the
    uninterrupted run."""
    cfg = port_config(JModelConfig("t", "dense", n_layers=2, d_model=16, n_heads=2,
                                   n_kv_heads=1, head_dim=8, d_ff=32, vocab_size=32,
                                   remat=False, dtype="float32"))
    opt = topt.adamw(topt.warmup_cosine(1e-2, warmup=2, total=20))
    step = tts.make_train_step(cfg, opt, accum_steps=2)

    def batch_fn(s):
        toks = np.random.default_rng(100 + s).integers(0, 32, (4, 9)).astype(np.int32)
        return {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}

    def run(path, n, fail=None):
        losses = []

        def logged(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        init = tts.init_train_state(make_generator(0), cfg, opt)
        loop = FaultTolerantLoop(logged, batch_fn, path, ckpt_every=2)
        try:
            state, _ = loop.run(init, n, simulate_failure_at=fail)
        except RuntimeError:
            state = None
        return state, losses

    golden, golden_losses = run(tmp_path / "golden", 6)
    _, first = run(tmp_path / "crashy", 6, fail=5)
    resumed, rest = run(tmp_path / "crashy", 6)
    assert first + rest[-1:] == golden_losses and first[:4] + rest == golden_losses
    assert int(resumed.step) == int(golden.step) == 6
    got, want = topt.leaf_groups(resumed.params), topt.leaf_groups(golden.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.value(), b.value(), rtol=0, atol=0)


def test_restart_without_a_checkpoint_starts_from_the_initial_values(tmp_path):
    """One loop and one ``init_state``: a failure before the first checkpoint
    (``ckpt_every=4``, failure at step 2), then ``run`` again with the same
    ``init_state``, which the train step updated in place.  The restart's
    losses are the uninterrupted run's, bit for bit, and so is its state."""
    cfg = port_config(JModelConfig("t", "dense", n_layers=2, d_model=16, n_heads=2,
                                   n_kv_heads=1, head_dim=8, d_ff=32, vocab_size=32,
                                   remat=False, dtype="float32"))
    opt = topt.adamw(topt.warmup_cosine(1e-2, warmup=2, total=20))
    step = tts.make_train_step(cfg, opt, accum_steps=2)
    losses = []

    def logged(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        return state, m

    def batch_fn(s):
        toks = np.random.default_rng(100 + s).integers(0, 32, (4, 9)).astype(np.int32)
        return {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}

    golden_loop = FaultTolerantLoop(logged, batch_fn, tmp_path / "golden", ckpt_every=4)
    golden, _ = golden_loop.run(tts.init_train_state(make_generator(0), cfg, opt), 6)
    golden_losses, losses[:] = list(losses), []

    init = tts.init_train_state(make_generator(0), cfg, opt)
    loop = FaultTolerantLoop(logged, batch_fn, tmp_path / "crashy", ckpt_every=4)
    with pytest.raises(RuntimeError, match="simulated node failure at step 2"):
        loop.run(init, 6, simulate_failure_at=2)
    assert losses == golden_losses[:2]
    losses[:] = []
    resumed, _ = loop.run(init, 6)
    assert losses == golden_losses
    assert int(resumed.step) == 6
    for a, b in zip(topt.leaf_groups(resumed.params), topt.leaf_groups(golden.params)):
        torch.testing.assert_close(a.value(), b.value(), rtol=0, atol=0)
