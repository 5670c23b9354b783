"""SubsetStrategy registry — "how the subset is found" as a pluggable axis.

The port of the JAX package's ``core/strategies.py`` (read its docstring for
the design).  A strategy is a callable

    (generator: torch.Generator, coded: CodedDataset, n, m, **opts) -> DSTResult-like

registered under a name; every strategy's output is normalized to one
host-side ``SubsetResult``, which ``core/plan.execute`` consumes.  The
conversion to the host is the one transfer of a strategy run.

Registered here: ``gen_dst``, ``gen_dst_islands`` and ``random``.  The
paper's baselines and the ASP-style proxy scorer are not ported yet
(ROADMAP.md).  Unknown names raise ``ValueError`` listing what exists.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .gen_dst import GenDSTConfig, gen_dst, random_dst
from .measures import CodedDataset

__all__ = [
    "SubsetResult", "StrategySpec", "register_strategy", "get_strategy",
    "available_strategies", "run_strategy", "STRATEGIES",
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
    returns a DSTResult-like with ``row_idx`` / ``col_mask`` / ``fitness``."""
    name: str
    fn: Callable
    description: str = ""


STRATEGIES: Dict[str, StrategySpec] = {}


def register_strategy(name: str, fn: Callable, *, description: str = "",
                      overwrite: bool = False) -> StrategySpec:
    """Register a SubsetStrategy under ``name``; returns its spec."""
    if not overwrite and name in STRATEGIES:
        raise ValueError(f"strategy {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    spec = StrategySpec(name=name, fn=fn, description=description)
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


def _to_subset_result(dst, strategy: str, t0: float) -> SubsetResult:
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    row_idx, col_mask = host(dst.row_idx), host(dst.col_mask)
    return SubsetResult(
        row_idx=row_idx.astype(np.int32),
        col_mask=col_mask.astype(bool),
        fitness=float(dst.fitness),
        strategy=strategy,
        time_s=time.perf_counter() - t0,
    )


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
    device work."""
    if callable(strategy):
        fn, name = strategy, getattr(strategy, "__name__", "<callable>")
    else:
        spec = get_strategy(strategy)
        fn, name = spec.fn, spec.name
    t0 = time.perf_counter()
    dst = fn(generator, coded, n, m, **dict(opts))
    return _to_subset_result(dst, name, t0)


# ---------------------------------------------------------------------------
# built-in registrations
# ---------------------------------------------------------------------------


def _gen(generator, coded, n, m, *, cfg: GenDSTConfig = GenDSTConfig(), **kw):
    if kw:
        cfg = cfg._replace(**kw)
    return gen_dst(generator, coded, n, m, cfg, device=coded.device)


def _gen_islands(generator, coded, n, m, *, cfg: GenDSTConfig = GenDSTConfig(),
                 num_islands: int = 4, **kw):
    cfg = cfg._replace(num_islands=num_islands, **kw)
    return gen_dst(generator, coded, n, m, cfg, device=coded.device)


def _random(generator, coded, n, m):
    return random_dst(generator, coded, n, m, device=coded.device)


register_strategy("gen_dst", _gen, description="the paper's genetic DST search (§3.3)")
register_strategy("gen_dst_islands", _gen_islands,
                  description="island-parallel Gen-DST (DESIGN.md §5.5)")
register_strategy("random", _random, description="uniform random subset (trivial baseline)")
