"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Tensors cross between the two packages as numpy arrays; ``port_config``
and ``port_lm_params`` carry a reference LM config and its params across.  ``JaxDraws`` is a
draw provider for ``repro_torch.core.gen_dst`` that replays the JAX
package's own key splits (``repro/core/gen_dst.py``), so the port's GA runs
on exactly the random numbers the reference's GA draws from the same key.
``np_strategy_registered`` registers one deterministic numpy subset strategy
in both packages, so a served fleet gets the same subsets from each.
"""
from __future__ import annotations

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

# the JAX-free helpers (tests/_card.py), kept importable from here
from _card import np_, t  # noqa: F401


def port_config(jcfg):
    """The port's ``ModelConfig`` with the fields of the reference's ``jcfg``
    that it keeps (dtype names become ``torch.dtype``s)."""
    import dataclasses

    from repro_torch.models.config import ModelConfig
    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in kept}
    for k in ("dtype", "param_dtype", "logit_dtype"):
        fields[k] = getattr(torch, fields[k])
    return ModelConfig(**fields)


def port_lm_params(jparams, cfg, device="cpu"):
    """The reference's LM params as the port's (``convert.lm_params_from_numpy``)."""
    from repro_torch.convert import lm_params_from_numpy
    return lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device)


# ---------------------------------------------------------------------------
# the reference's draws, one island (the reference vmaps these over islands)
# ---------------------------------------------------------------------------


def _uniform_rows(keys, M):
    return jax.vmap(lambda k: jax.random.uniform(k, (M,)))(keys)


def _randint_rows(keys, n, N):
    return jax.vmap(lambda k: jax.random.randint(k, (n,), 0, N, dtype=jnp.int32))(keys)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def init_draws(key, phi, N, M, n):
    """``_init_population``'s draws (``gen_dst.py:151-160``)."""
    kr, kc, kd = jax.random.split(key, 3)
    return {"rows": jax.random.randint(kr, (phi, n), 0, N, dtype=jnp.int32),
            "dedup": _randint_rows(jax.random.split(kd, phi), n, N),
            "col_u": _uniform_rows(jax.random.split(kc, phi), M)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def mutate_draws(key, phi, N, M, n):
    """``_mutate_core``'s draws (``gen_dst.py:234-257``)."""
    k1, k2, k3, k4, k5, _ = jax.random.split(key, 6)
    pair = jax.vmap(jax.random.split)(jax.random.split(k5, phi))      # (phi, 2)
    return {"u_mut": jax.random.uniform(k1, (phi,)), "u_rc": jax.random.uniform(k2, (phi,)),
            "slot": jax.random.randint(k3, (phi,), 0, n),
            "fresh": jax.random.randint(k4, (phi,), 0, N, dtype=jnp.int32),
            "u_off": _uniform_rows(pair[:, 0], M), "u_on": _uniform_rows(pair[:, 1], M)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def cross_draws(key, phi, N, M, n, m):
    """``_crossover``'s draws (``gen_dst.py:288-329``).  A row permutation
    ``permutation(k, r)`` is drawn as the index permutation
    ``permutation(k, n)``, which it applies to ``r``."""
    half = phi // 2
    kp, kt, ks, kra, krb, kca, kcb, kfa, kfb, kda, kdb = jax.random.split(key, 11)
    ksr, ksc = jax.random.split(ks)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n))
    ca = jax.vmap(jax.random.split)(jax.random.split(kca, half))
    cb = jax.vmap(jax.random.split)(jax.random.split(kcb, half))
    return {"perm": jax.random.permutation(kp, phi),
            "u_cross": jax.random.uniform(kt, (half,)),
            "s_r": jax.random.randint(ksr, (half,), 1, jnp.maximum(n, 2)),
            "s_c": jax.random.randint(ksc, (half,), 1, jnp.maximum(m - 1, 2)),
            "pi_a": perms(jax.random.split(kra, half)), "pi_b": perms(jax.random.split(krb, half)),
            "fresh_ab": _randint_rows(jax.random.split(kda, half), n, N),
            "fresh_ba": _randint_rows(jax.random.split(kdb, half), n, N),
            "u_ab1": _uniform_rows(ca[:, 0], M), "u_ab2": _uniform_rows(ca[:, 1], M),
            "u_abf": _uniform_rows(jax.random.split(kfa, half), M),
            "u_ba1": _uniform_rows(cb[:, 0], M), "u_ba2": _uniform_rows(cb[:, 1], M),
            "u_baf": _uniform_rows(jax.random.split(kfb, half), M)}


_INDEX_DRAWS = ("slot", "perm", "pi_a", "pi_b", "s_r", "s_c")


def to_port(draws_per_island) -> dict:
    """Stack per-island draws on a leading island axis as torch tensors
    (index draws as int64, row draws as int32, uniforms as float32)."""
    out = {}
    for name in draws_per_island[0]:
        arr = np.stack([np.asarray(d[name]) for d in draws_per_island])
        dtype = (torch.int64 if name in _INDEX_DRAWS else
                 torch.int32 if arr.dtype.kind in "iu" else torch.float32)
        out[name] = torch.as_tensor(arr, dtype=dtype)
    return out


class JaxDraws:
    """Draw provider that replays ``_gen_dst_core``'s key flow: ``k0, kloop =
    split(key)``; islands from ``split(k0, I)``; per generation ``key, km,
    kx, ksel = split(key, 4)`` and per island ``split(km|kx|ksel, I)``."""

    def __init__(self, key):
        self.k0, self.key = jax.random.split(key)

    def init(self, I, phi, N, M, n):
        return to_port([init_draws(k, phi, N, M, n) for k in jax.random.split(self.k0, I)])

    def generation(self):
        self.key, km, kx, ksel = jax.random.split(self.key, 4)
        return _JaxGeneration(km, kx, ksel)


class _JaxGeneration:
    def __init__(self, km, kx, ksel):
        self.km, self.kx, self.ksel = km, kx, ksel

    def mutate(self, I, phi, N, M, n):
        return to_port([mutate_draws(k, phi, N, M, n) for k in jax.random.split(self.km, I)])

    def cross(self, I, phi, N, M, n, m):
        return to_port([cross_draws(k, phi, N, M, n, m) for k in jax.random.split(self.kx, I)])

    def select(self, probs, k):
        """``jax.random.choice(key, phi, (k,), p=...)`` per island."""
        drawn = _choice(jax.random.split(self.ksel, probs.shape[0]), jnp.asarray(np_(probs)), k)
        return torch.as_tensor(np.array(drawn), dtype=torch.int64)


@functools.partial(jax.jit, static_argnums=(2,))
def _choice(keys, probs, k):
    phi = probs.shape[1]
    return jax.vmap(lambda kk, p: jax.random.choice(kk, phi, (k,), replace=True, p=p))(keys, probs)


class JaxKey:
    """Draw provider that stands for one ``jax.random`` key, for the port's
    baselines (``repro_torch.core.baselines``) and ``kmeans``: ``split`` splits
    the key as the reference does, and each draw is the reference's own call
    on this key, so two draws from one provider repeat the reference's reuse
    of a key."""

    def __init__(self, key):
        self.key = key

    def split(self, num: int = 2):
        return [JaxKey(k) for k in jax.random.split(self.key, num)]

    def uniform(self, *shape):
        return t(jax.random.uniform(self.key, shape))

    def randint(self, high, *shape):
        return t(jax.random.randint(self.key, shape, 0, high, dtype=jnp.int32))

    def choice(self, P, k):
        return t(jax.random.choice(self.key, P, (k,), replace=False), torch.int64)

    def init(self, I, phi, N, M, n):
        """``_init_population(key, ..., phi)``'s draws, one island."""
        assert I == 1
        return to_port([init_draws(self.key, phi, N, M, n)])


# ---------------------------------------------------------------------------
# one deterministic numpy subset strategy, registered in both packages
# ---------------------------------------------------------------------------


def np_subset(codes, n_bins, target_col, n, m):
    """Rows ranked by a hash of their codes, the m - 1 columns with the most
    bins and the target; fitness -|H(d) - H(D)| over the kept columns in
    float64.  A pure function of the table, so cacheable."""
    N, M = codes.shape
    n = int(np.sqrt(N)) if n is None else n
    m = max(2, int(0.25 * M)) if m is None else m
    score = (codes.astype(np.int64) * (np.arange(M) * 7919 + 1)).sum(1) % 1009
    rows = np.argsort(score, kind="stable")[:n].astype(np.int32)
    feats = [j for j in np.argsort(-n_bins, kind="stable") if j != target_col][:m - 1]
    mask = np.zeros(M, bool)
    mask[feats] = True
    mask[target_col] = True

    def entropy(block):
        h = []
        for j in np.flatnonzero(mask):
            p = np.bincount(block[:, j]) / len(block)
            p = p[p > 0]
            h.append(-(p * np.log2(p)).sum())
        return float(np.mean(h))
    return types.SimpleNamespace(row_idx=rows, col_mask=mask,
                                 fitness=-abs(entropy(codes[rows]) - entropy(codes)))


def j_np(key, coded, n, m):
    return np_subset(np.asarray(coded.codes), np.asarray(coded.n_bins), coded.target_col, n, m)


def t_np(generator, coded, n, m):
    from repro_torch.core.measures import host_codes
    codes, n_bins = host_codes(coded)
    return np_subset(codes, n_bins, coded.target_col, n, m)


@contextlib.contextmanager
def np_strategy_registered(name: str):
    """``np_subset`` registered under ``name`` in both packages (batchable and
    cacheable), removed on exit: the registries are process-global and other
    test files count them."""
    from repro.core.strategies import STRATEGIES as J_STRATEGIES, register_strategy as j_reg
    from repro_torch.core.strategies import STRATEGIES as T_STRATEGIES, register_strategy as t_reg
    j_reg(name, j_np, overwrite=True,
          batch_fn=lambda keys, cs, n, m: [j_np(k, c, n, m) for k, c in zip(keys, cs)])
    t_reg(name, t_np, overwrite=True,
          batch_fn=lambda gens, cs, n, m: [t_np(g, c, n, m) for g, c in zip(gens, cs)])
    try:
        yield name
    finally:
        del J_STRATEGIES[name], T_STRATEGIES[name]


# ---------------------------------------------------------------------------
# meshes and shapes without devices
# ---------------------------------------------------------------------------


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the port's
    ``init_params`` (which draws on ``generator.device``) builds a full-size
    tree of meta tensors: shapes and dtypes, no memory."""

    @property
    def device(self):
        return torch.device("meta")


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` on the fake process group (one process
    stands for every rank; collectives do nothing), torn down on exit."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device="cpu")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_RANK_PREAMBLE = """
import json, sys
import torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", rank=rank,
                        world_size=world)
torch.manual_seed(0)
"""


def run_ranks(body: str, world: int, tmp_path, timeout: float = 50.0) -> list:
    """Run ``body`` in ``world`` processes joined by one gloo process group
    (the preamble gives it ``rank``, ``world``, ``dist`` and ``json``, with
    ``repro_torch`` importable and no JAX), then destroy the group.  Returns
    each rank's standard output; raises if a rank fails or the whole run
    takes longer than ``timeout`` seconds."""
    import os
    import subprocess
    import sys
    import textwrap
    import time
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    script = Path(tmp_path) / "ranks.py"
    script.write_text(_RANK_PREAMBLE.format(src=src) + textwrap.dedent(body)
                      + "\ndist.destroy_process_group()\n")
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"rank failed ({p.returncode}):\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
