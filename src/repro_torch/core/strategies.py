"""SubsetStrategy registry — "how the subset is found" as a pluggable axis.

The port of the JAX package's ``core/strategies.py`` (read its docstring for
the design).  A strategy is a callable

    (generator: torch.Generator, coded: CodedDataset, n, m, **opts) -> DSTResult-like

registered under a name; every strategy's output is normalized to one
host-side ``SubsetResult``, which ``core/plan.execute`` consumes.  The
conversion to the host is the one transfer of a strategy run.  A strategy
with a ``batch_fn`` also runs several same-shaped searches as one
(``gen_dst_batch``); ``run_strategy_batch`` falls back to one run per
dataset for the others.

Registered here, as in the reference: Gen-DST and its island variant, the
uniform random subset, the paper's baselines (``core/baselines.py``) and the
ASP-style proxy scorer.  Each runs on the device of the dataset it is given.
Unknown names raise ``ValueError`` listing what exists.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs import trace as _trace
from . import baselines as B
from .gen_dst import (
    DSTResult, GenDSTConfig, _default_draws, _on_device, _resolve_nm, gen_dst, gen_dst_batch,
    random_dst,
)
from .measures import CodedDataset

__all__ = [
    "SubsetResult", "StrategySpec", "register_strategy", "get_strategy",
    "available_strategies", "run_strategy", "run_strategy_batch",
    "asp_proxy_dst", "STRATEGIES",
]


@dataclasses.dataclass(frozen=True)
class SubsetResult:
    """Uniform host-side output of every SubsetStrategy."""
    row_idx: np.ndarray        # (n,) host int32 row indices
    col_mask: np.ndarray       # (M,) host bool column mask (target incl.)
    fitness: float             # -|F(d) - F(D)| (NaN for unscored strategies)
    strategy: str              # registry name (or "<callable>")
    time_s: float              # wall seconds spent producing the subset


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """One registered SubsetStrategy: ``fn(generator, coded, n, m, **opts)``
    returns a DSTResult-like with ``row_idx`` / ``col_mask`` / ``fitness``.
    ``batch_fn(generators, codeds, n, m, **opts)``, when set, returns one
    result per same-shaped dataset from one search.  ``cacheable`` marks
    strategies whose output is a pure function of ``(dataset, n, m, opts)``
    given the generator."""
    name: str
    fn: Callable
    batch_fn: Optional[Callable] = None
    cacheable: bool = True
    description: str = ""


STRATEGIES: Dict[str, StrategySpec] = {}


def register_strategy(name: str, fn: Callable, *, batch_fn: Optional[Callable] = None,
                      cacheable: bool = True, description: str = "",
                      overwrite: bool = False) -> StrategySpec:
    """Register a SubsetStrategy under ``name``; returns its spec."""
    if not overwrite and name in STRATEGIES:
        raise ValueError(f"strategy {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    spec = StrategySpec(name=name, fn=fn, batch_fn=batch_fn, cacheable=cacheable,
                        description=description)
    STRATEGIES[name] = spec
    return spec


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(STRATEGIES))


def get_strategy(name: str) -> StrategySpec:
    """Look up a registered strategy; unknown names list what exists."""
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown subset strategy {name!r}; available strategies: "
            f"{', '.join(available_strategies())}") from None


def _host(dst) -> tuple:
    """A result's rows, mask and fitness on the host."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return host(dst.row_idx).astype(np.int32), host(dst.col_mask).astype(bool), float(dst.fitness)


def run_strategy(
    strategy: Union[str, Callable],
    generator: Optional[torch.Generator],
    coded: CodedDataset,
    n: Optional[int],
    m: Optional[int],
    opts: Sequence[Tuple[str, object]] = (),
) -> SubsetResult:
    """Execute one strategy and normalize its output to a ``SubsetResult``.

    ``strategy`` is a registry name or a bare callable; ``opts`` is a
    ``(key, value)`` item sequence forwarded as keyword arguments.  The
    time includes the transfer of the result to the host, so it covers the
    device work; a ``gen_dst.to_host`` span (``obs/trace``) covers that
    transfer, which waits for the search's device work."""
    if callable(strategy):
        fn, name = strategy, getattr(strategy, "__name__", "<callable>")
    else:
        spec = get_strategy(strategy)
        fn, name = spec.fn, spec.name
    t0 = time.perf_counter()
    dst = fn(generator, coded, n, m, **dict(opts))
    with _trace.span(None, None, "gen_dst.to_host"):
        rows, mask, fitness = _host(dst)
    return SubsetResult(rows, mask, fitness, name, time.perf_counter() - t0)


def run_strategy_batch(
    strategy: str,
    generators: Sequence[Optional[torch.Generator]],
    codeds: Sequence[CodedDataset],
    n: Optional[int],
    m: Optional[int],
    opts: Sequence[Tuple[str, object]] = (),
) -> List[SubsetResult]:
    """Execute one strategy over several same-shaped datasets as one search
    when it has a ``batch_fn`` (each result's ``time_s`` is an equal share
    of the whole, transfers included), else one run per dataset."""
    spec = get_strategy(strategy)
    if spec.batch_fn is None:
        return [run_strategy(strategy, g, c, n, m, opts) for g, c in zip(generators, codeds)]
    t0 = time.perf_counter()
    hosted = [_host(d) for d in spec.batch_fn(generators, codeds, n, m, **dict(opts))]
    share = (time.perf_counter() - t0) / max(len(hosted), 1)
    return [SubsetResult(rows, mask, fitness, spec.name, share)
            for rows, mask, fitness in hosted]


# ---------------------------------------------------------------------------
# ASP-style proxy scorer (arXiv 2310.11478 flavor)
# ---------------------------------------------------------------------------


def asp_proxy_dst(generator: Optional[torch.Generator], coded: CodedDataset, n=None, m=None,
                  *, hard_frac: float = 0.5, device=None, draws=None) -> DSTResult:
    """ASP-style automatic proxy-data selection (cf. arXiv 2310.11478); the
    reference's docstring (``strategies.py:199-216``) states the method.

    Columns: the m - 1 highest information-gain features and the target.
    Rows: per class, a slot count proportional to its frequency (at least
    1), filled by an even quantile sweep over the class's nearest-centroid
    margin ranking, which ``hard_frac`` pushes toward the boundary.  The
    rows are chosen in host numpy, as in the reference, so this strategy
    reads the table back to the host.  Where rounding leaves a class short,
    its slots are filled at random by numpy, seeded with one integer drawn
    from ``generator`` (or ``draws``, as the baselines take them; the
    reference draws it from ``fold_in(key, 0xA59)``)."""
    coded, dev = _on_device(coded, device)
    if draws is None:
        draws = _default_draws(generator, dev)
    n, m = _resolve_nm(coded, n, m)
    tgt = coded.target_col

    # columns: IG ranking (proxy feature relevance), the IG baselines' rule
    col_mask = B._ig_cols(coded, m).cpu().numpy()

    # rows: class-stratified margin quantiles (proxy difficulty)
    vals = coded.values.cpu().numpy()
    y = coded.codes[:, tgt].cpu().numpy()
    feats = np.delete(np.arange(vals.shape[1]), tgt)
    Z = vals[:, feats]
    Z = (Z - Z.mean(0)) / (Z.std(0) + 1e-9)
    classes, counts = np.unique(y, return_counts=True)
    cents = np.stack([Z[y == c].mean(0) for c in classes])       # (C, d)
    d2 = ((Z[:, None, :] - cents[None]) ** 2).sum(-1)            # (N, C)
    own = d2[np.arange(len(y)), np.searchsorted(classes, y)]
    other = np.where(
        np.arange(len(classes))[None] == np.searchsorted(classes, y)[:, None],
        np.inf, d2).min(1)
    margin = own - other          # low = prototypical, high = boundary

    # proportional slots, every class >= 1; trim largest classes on overflow
    slots = np.maximum(1, np.round(n * counts / counts.sum()).astype(int))
    while slots.sum() > n:
        slots[np.argmax(slots)] -= 1
    while slots.sum() < n:
        slots[np.argmax(counts - slots)] += 1

    rng = np.random.default_rng(int(draws.randint(np.iinfo(np.int32).max)))
    rows = []
    for cls, k in zip(classes, slots):
        members = np.flatnonzero(y == cls)
        k = min(int(k), len(members))
        order = members[np.argsort(margin[members])]
        # quantile sweep over the easy..hard ranking; hard_frac biases how
        # deep into the boundary region the sweep reaches
        span = max(1, int(round(len(order) * (0.5 + 0.5 * hard_frac))))
        pick = np.unique(np.linspace(0, span - 1, k).round().astype(int))
        chosen = order[pick]
        if len(chosen) < k:   # rounding collisions: fill with random members
            pool = np.setdiff1d(order, chosen)
            chosen = np.concatenate(
                [chosen, rng.choice(pool, k - len(chosen), replace=False)])
        rows.append(chosen)
    row_idx = np.sort(np.concatenate(rows))[:n].astype(np.int32)

    rows_t = torch.as_tensor(row_idx, device=dev)
    cm_t = torch.as_tensor(col_mask, device=dev)
    fitness, f_ref = B._subset_fitness(coded, rows_t, cm_t)
    return DSTResult(rows_t, cm_t, fitness, torch.zeros(0, device=dev), f_ref)


# ---------------------------------------------------------------------------
# built-in registrations
# ---------------------------------------------------------------------------


def _gen(generator, coded, n, m, *, cfg: GenDSTConfig = GenDSTConfig(), **kw):
    if kw:
        cfg = cfg._replace(**kw)
    return gen_dst(generator, coded, n, m, cfg, device=coded.device)


def _gen_batch(generators, codeds, n, m, *, cfg: GenDSTConfig = GenDSTConfig(), **kw):
    if kw:
        cfg = cfg._replace(**kw)
    return gen_dst_batch(generators, codeds, n, m, cfg, device=codeds[0].device)


def _gen_islands(generator, coded, n, m, *, cfg: GenDSTConfig = GenDSTConfig(),
                 num_islands: int = 4, **kw):
    cfg = cfg._replace(num_islands=num_islands, **kw)
    return gen_dst(generator, coded, n, m, cfg, device=coded.device)


def _gen_islands_batch(generators, codeds, n, m, *, cfg: GenDSTConfig = GenDSTConfig(),
                       num_islands: int = 4, **kw):
    cfg = cfg._replace(num_islands=num_islands, **kw)
    return gen_dst_batch(generators, codeds, n, m, cfg, device=codeds[0].device)


def _on_coded_device(fn: Callable) -> Callable:
    """``fn`` run on the device of the dataset it is given."""
    def run(generator, coded, n, m, **opts):
        return fn(generator, coded, n, m, device=coded.device, **opts)
    run.__name__ = fn.__name__
    return run


register_strategy("gen_dst", _gen, batch_fn=_gen_batch,
                  description="the paper's genetic DST search (§3.3)")
register_strategy("gen_dst_islands", _gen_islands, batch_fn=_gen_islands_batch,
                  description="island-parallel Gen-DST (DESIGN.md §5.5)")
register_strategy("random", _on_coded_device(random_dst), cacheable=False,
                  description="uniform random subset (trivial baseline)")
register_strategy("mc", _on_coded_device(B.mc_dst),
                  description="Monte-Carlo search (paper §4.2 cat. A)")
register_strategy("mab", _on_coded_device(B.mab_dst),
                  description="eps-greedy multi-arm bandit (cat. B)")
register_strategy("greedy_seq", _on_coded_device(B.greedy_seq_dst),
                  description="greedy rows-then-columns (cat. C)")
register_strategy("greedy_mult", _on_coded_device(B.greedy_mult_dst),
                  description="greedy row+column co-selection (cat. C)")
register_strategy("km", _on_coded_device(B.km_dst),
                  description="k-means representatives (cat. D)")
register_strategy("ig_rand", _on_coded_device(B.ig_rand_dst),
                  description="IG columns + random rows (cat. E)")
register_strategy("ig_km", _on_coded_device(B.ig_km_dst),
                  description="IG columns + k-means rows (cat. E)")
register_strategy("asp_proxy", _on_coded_device(asp_proxy_dst),
                  description="ASP-style proxy-data scorer (arXiv 2310.11478 flavor)")
