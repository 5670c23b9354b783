"""The port's ``train/optimizer.py`` against the JAX package's on the CPU.

The port's params hold one tensor per layer where the reference stacks the
layers; each optimizer must compute what the reference computes on the
stacked tree.  The tree here is the zamba2-2.7b smoke config's (hybrid):
stacked norm scales and per-head vectors ``(L, D)``/``(L, H)`` (AdamW
decays them, Adafactor factors them with one column statistic shared by the
layers), stacked matrices, the shared attention block's unstacked
``(D, H, hd)`` weights (sliced by ``scan_update_threshold``), and the
unstacked embedding and final norm.  Both packages get the same numpy
gradients for three updates.

Tolerances: params within 1e-5 relative to each leaf's largest magnitude
(float32: the update's sums run in another order), the state within 1e-5 of
each entry's largest magnitude, and every state shape equal.  The
schedule within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt
from _torch_port import port_config, port_lm_params

TOL = 1e-5
OPTIMIZERS = {
    "adamw": dict(weight_decay=0.1),
    "adafactor": dict(),
    "adafactor_beta1": dict(beta1=0.9, weight_decay=0.1),
    "adafactor_scan": dict(scan_update_threshold=1000),
}


@pytest.fixture(scope="module")
def tree():
    jcfg = dataclasses.replace(j_get_arch("zamba2-2.7b").smoke, dtype="float32", remat=False)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    cfg = port_config(jcfg)
    return jparams, cfg


def _grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), jparams)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err} > {TOL}"


def _stacked(group):
    return (torch.stack(group.tensors) if group.stacked else group.tensors[0]).numpy()


def test_leaf_groups_follow_the_reference_leaves(tree):
    jparams, cfg = tree
    groups = topt.leaf_groups(port_lm_params(jparams, cfg))
    leaves = jax.tree.leaves(jparams)
    assert [g.shape for g in groups] == [tuple(a.shape) for a in leaves]
    for g, a in zip(groups, leaves):
        np.testing.assert_array_equal(_stacked(g), np.asarray(a))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_updates_equal_the_reference(tree, name):
    jparams, cfg = tree
    kw = OPTIMIZERS[name]
    kind = name.split("_")[0]
    lr = lambda s: 1e-2                                          # noqa: E731
    jo = jopt.make_optimizer(kind, lr, **kw)
    to = topt.make_optimizer(kind, lr, **kw)
    params = port_lm_params(jparams, cfg)
    jp, jst = jparams, jo.init(jparams)
    tst = to.init(params)
    for step in range(3):
        g = _grads(jparams, seed=step)
        jp, jst = jo.update(jax.tree.map(jnp.asarray, g), jst, jp, jnp.int32(step))
        out = to.update(port_lm_params(g, cfg), tst, params, torch.tensor(step, dtype=torch.int32))
        assert out[0] is params and out[1] is tst            # updated in place
    for i, (grp, want) in enumerate(zip(topt.leaf_groups(params), jax.tree.leaves(jp))):
        _close(_stacked(grp), want, f"param leaf {i} {grp.shape}")
    jleaves = jax.tree.leaves(jst)
    tleaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tst))
    assert len(tleaves) == len(jleaves)
    for i, (got, want) in enumerate(zip(tleaves, jleaves)):
        _close(got, want, f"state leaf {i}")


def test_stacked_norm_scale_shares_its_column_statistic(tree):
    """A stacked (L, D) norm scale is factored: (L,) row statistics and one
    (D,) column statistic for all layers, as in the reference; an unstacked
    vector keeps its full second moment."""
    jparams, cfg = tree
    params = port_lm_params(jparams, cfg)
    st = topt.adafactor(lambda s: 1e-3).init(params)
    groups = topt.leaf_groups(params)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    norm = paths.index("['layers']['norm']")
    L, D = cfg.n_layers, cfg.d_model
    assert groups[norm].shape == (L, D)
    assert st["v"][norm]["vr"].shape == (L,) and st["v"][norm]["vc"].shape == (D,)
    final = paths.index("['final_norm']")
    assert set(st["v"][final]) == {"v"} and st["v"][final]["v"].shape == (D,)
    assert len(paths) == len(groups)


@pytest.mark.parametrize("step", [0, 10, 100, 150])
def test_warmup_cosine_equals_the_reference(step):
    want = float(jopt.warmup_cosine(1e-3, warmup=10, total=100, floor=0.1)(jnp.int32(step)))
    got = topt.warmup_cosine(1e-3, warmup=10, total=100, floor=0.1)(step)
    assert got == pytest.approx(want, rel=1e-6)
    if step == 0:
        assert got < 2e-4
    if step >= 100:
        assert got == pytest.approx(1e-4, rel=1e-5)
