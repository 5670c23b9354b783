"""Gen-DST (SubStrat Algorithm 1): the genetic subset search in PyTorch.

The port of the JAX package's ``core/gen_dst.py``; read that module's
docstring for the genome (rows (phi, n) int32, column mask (phi, M) with the
target pinned), the incremental-fitness design and the fixed-shape set
operations.  What differs here:

* **Batch axis written out.**  The reference vmaps over islands; here every
  operator takes an explicit leading island axis: rows (I, phi, n), column
  masks (I, phi, M), counts (I, phi, M, B).
* **Draws apart from operators.**  ``jax.random`` keys become a
  ``torch.Generator``, and the two give different numbers.  So each
  randomized operator is a pure function of its draws (tensors), and a draw
  provider makes them: ``TorchDraws`` in production; the tests supply one
  that replays the reference's own key splits, which makes every operator,
  and whole runs, comparable bit for bit.
* **One fitness path.**  The generation loop has the structure of the
  reference's fused path (``gen_dst.py:458-488``): on recompute generations
  the population's histograms are rebuilt by ``population_histogram_rows``
  (the masked-histogram kernel, which gathers the rows itself), and on
  every generation ``fused_delta_fitness`` (the fused kernel) applies the
  row delta and reduces to fitness, with ``applied = 0`` after a recompute.  The initial
  fitness goes through it too, with a zero delta.  On a CUDA device both
  kernels run; on the CPU their plain versions do.  The device chooses, so
  the reference's ``backend`` field is gone.
* **One transfer per run.**  The generation loop is a Python loop whose
  tensors stay on the device: best-so-far tracking is ``torch.where``, and
  nothing is read back until the caller converts the result
  (DESIGN.md §5.3).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import DeviceLike, make_generator, resolve_device
from ..kernels.entropy.ops import population_histogram_rows
from ..kernels.gen_dst.ops import fused_delta_fitness
from .measures import MEASURES, CodedDataset, full_column_entropy

__all__ = ["GenDSTConfig", "DSTResult", "TorchDraws", "gen_dst",
           "default_dst_size", "random_dst"]


def _validate_cfg(cfg: "GenDSTConfig") -> None:
    """Fail fast on a config the GA cannot run."""
    if cfg.phi % 2 != 0:
        raise ValueError("population size must be even (pairwise crossover)")
    if cfg.num_islands < 1 or cfg.cross_every < 1 or cfg.migrate_every < 1:
        raise ValueError("num_islands, cross_every and migrate_every must be >= 1")
    if cfg.measure not in MEASURES:
        raise ValueError(f"unknown measure {cfg.measure!r}; expected one of "
                         f"{', '.join(MEASURES)}")


class GenDSTConfig(NamedTuple):
    psi: int = 30          # generations
    phi: int = 100         # population size PER ISLAND (must be even)
    xi: float = 0.025      # mutation probability per candidate
    alpha: float = 0.05    # royalty (elite) fraction
    p_rc: float = 0.9      # P(mutate/cross rows) vs columns
    measure: str = "entropy"
    # --- search-loop extensions (DESIGN.md §5.5) ----------------------------
    incremental: bool = True   # delta-update counts on mutation-only gens
    cross_every: int = 1   # crossover every k-th generation (1 = seed-faithful)
    num_islands: int = 1   # independent sub-populations
    migrate_every: int = 5     # generations between elite migrations
    migrate_frac: float = 0.1  # fraction of phi migrated per event


class DSTResult(NamedTuple):
    row_idx: torch.Tensor     # (n,) int32
    col_mask: torch.Tensor    # (M,) bool
    fitness: torch.Tensor     # scalar, = -|F(d) - F(D)|
    history: torch.Tensor     # (psi,) best fitness per generation
    f_ref: torch.Tensor       # F(D)


def default_dst_size(N: int, M: int) -> tuple[int, int]:
    """Paper default DST size: (sqrt(N), 0.25*M), clamped to the data."""
    n = max(2, min(N, int(round(float(N) ** 0.5))))
    m = max(2, min(M, int(round(0.25 * M))))
    return n, m


# ---------------------------------------------------------------------------
# fixed-shape mask utilities (last axis)
# ---------------------------------------------------------------------------


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of scores[i] in descending order (0 = largest).

    Stable, as ``jnp.argsort`` is: tied scores (the many ``-inf`` of
    non-members) rank by index."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _sample_members(u: torch.Tensor, mask: torch.Tensor, k) -> torch.Tensor:
    """Sub-mask with min(k, |mask|) True entries of ``mask``, chosen by the
    uniform draws ``u`` (same shape as ``mask``); ``k`` broadcasts."""
    scores = u - torch.where(mask, 0.0, float("inf"))
    return mask & (_rank_desc(scores) < k)


def _refill_to(u: torch.Tensor, mask: torch.Tensor, m, forbidden: Optional[torch.Tensor] = None):
    """Add positions outside ``mask`` (and ``forbidden``), chosen by ``u``,
    until |mask| = m."""
    deficit = m - mask.sum(-1, keepdim=True)
    blocked = mask if forbidden is None else (mask | forbidden)
    scores = u - torch.where(blocked, float("inf"), 0.0)
    return mask | ((~blocked) & (_rank_desc(scores) < deficit))


def _dedup_rows(fresh: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Sort row-index vectors and replace duplicate slots with ``fresh``."""
    s = torch.sort(rows, dim=-1).values
    dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool),
                     s[..., 1:] == s[..., :-1]], dim=-1)
    return torch.where(dup, fresh, s)


def _target_mask(M: int, target: int, device) -> torch.Tensor:
    # a compare, not ``tgt[target] = True``: writing a host scalar into device
    # memory is a copy that waits for the host
    return torch.arange(M, device=device) == target


def _gather_cands(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i, j], ...] for x (I, phi, ...) and idx (I, k)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


# ---------------------------------------------------------------------------
# GA operators: pure functions of their draws (dicts of tensors)
# ---------------------------------------------------------------------------


def _init_population(d, N: int, M: int, n: int, m: int, target: int):
    """Initial (I, phi, n) rows and (I, phi, M) masks from the ``init`` draws."""
    rows = _dedup_rows(d["dedup"], d["rows"])
    tgt = _target_mask(M, target, rows.device).expand(d["col_u"].shape)
    cols = _refill_to(d["col_u"], tgt, m) | tgt
    return rows, cols


def _mutate_core(d, rows, cols, *, N, M, n, m, xi, p_rc, target):
    """Mutation + the bookkeeping incremental fitness needs.

    Returns (new_rows, new_cols, applied, old_vals, fresh): ``applied`` marks
    candidates whose ROW mutation fired; ``old_vals``/``fresh`` are the
    evicted/inserted row indices (ignored where not applied)."""
    do_mut = d["u_mut"] < xi
    mut_rows = d["u_rc"] < p_rc

    # --- row mutation: replace one random slot with a fresh index -----------
    slot = d["slot"].long()[..., None]
    fresh = d["fresh"]
    # skip if fresh already a member (keeps |r ∩ r'| = n-1 semantics cheaply)
    already = (rows == fresh[..., None]).any(-1)
    apply_row = do_mut & mut_rows & (~already)
    old_vals = torch.gather(rows, -1, slot)[..., 0]
    new_rows = rows.scatter(-1, slot, torch.where(apply_row, fresh, old_vals)[..., None])

    # --- column mutation: swap one ON (non-target) for one OFF column -------
    tgt = _target_mask(M, target, rows.device)
    off = _sample_members(d["u_off"], cols & ~tgt, 1)   # one member to drop
    on = _sample_members(d["u_on"], ~cols, 1)           # one non-member to add
    ok = ((off.sum(-1) == 1) & (on.sum(-1) == 1))[..., None]
    mutated_cols = torch.where(ok, (cols & ~off) | on, cols)
    apply_col = (do_mut & (~mut_rows))[..., None]
    new_cols = torch.where(apply_col, mutated_cols, cols)
    return new_rows, new_cols, apply_row, old_vals, fresh


def _crossover_splits(gen: torch.Generator, shape, n: int, m: int, device):
    """Independent row/column crossover split sizes ``s_r`` in [1, max(n, 2))
    and ``s_c`` in [1, max(m - 1, 2)), drawn separately: one shared draw
    would correlate the row and column split points."""
    s_r = torch.randint(1, max(n, 2), shape, generator=gen, device=gen.device).to(device)
    s_c = torch.randint(1, max(m - 1, 2), shape, generator=gen, device=gen.device).to(device)
    return s_r, s_c


def _crossover(d, rows, cols, *, N, M, n, m, p_rc, target):
    """Pairwise split-and-swap crossover over the whole population."""
    phi = rows.shape[1]
    half = phi // 2
    perm = d["perm"]
    ra, rb = _gather_cands(rows, perm[:, :half]), _gather_cands(rows, perm[:, half:])
    ca, cb = _gather_cands(cols, perm[:, :half]), _gather_cands(cols, perm[:, half:])

    cross_rows = (d["u_cross"] < p_rc)[..., None]
    s_r, s_c = d["s_r"], d["s_c"]

    # --- row crossover: child_ab = s rows of a + (n-s) rows of b ------------
    pa = torch.gather(ra, -1, d["pi_a"])
    pb = torch.gather(rb, -1, d["pi_b"])
    take_a = torch.arange(n, device=rows.device) < s_r[..., None]
    child_ab_rows = _dedup_rows(d["fresh_ab"], torch.where(take_a, pa, pb))
    child_ba_rows = _dedup_rows(d["fresh_ba"], torch.where(take_a, pb, pa))

    # --- column crossover: union of s members of a and (m-s) of b, refill ---
    tgt = _target_mask(M, target, rows.device)
    s = s_c[..., None]

    def col_child(u1, u2, uf, cma, cmb):
        u = _sample_members(u1, cma & ~tgt, s) | _sample_members(u2, cmb & ~tgt, m - 1 - s)
        return _refill_to(uf, u | tgt, m)

    child_ab_cols = col_child(d["u_ab1"], d["u_ab2"], d["u_abf"], ca, cb)
    child_ba_cols = col_child(d["u_ba1"], d["u_ba2"], d["u_baf"], cb, ca)

    # row-cross keeps own columns; col-cross keeps own rows (paper §3.3)
    new_rows = torch.cat([torch.where(cross_rows, child_ab_rows, ra),
                          torch.where(cross_rows, child_ba_rows, rb)], dim=1)
    new_cols = torch.cat([torch.where(cross_rows, ca, child_ab_cols),
                          torch.where(cross_rows, cb, child_ba_cols)], dim=1)
    return new_rows, new_cols


def _n_elite(phi: int, alpha: float) -> int:
    return max(1, int(round(alpha * phi)))


def _selection_probs(fitness: torch.Tensor) -> torch.Tensor:
    """Fitness-proportional weights on shifted fitness (fitness <= 0)."""
    w = fitness - fitness.min(-1, keepdim=True).values + 1e-9
    return w / w.sum(-1, keepdim=True)


def _select_idx(fitness: torch.Tensor, drawn: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """Royalty tournament: the top alpha*phi (stable order), then the
    ``drawn`` fitness-proportional picks."""
    elite = torch.argsort(-fitness, dim=-1, stable=True)[:, :_n_elite(fitness.shape[-1], alpha)]
    return torch.cat([elite, drawn.to(elite.dtype)], dim=-1)


def _ring_migrate(rows, cols, counts, fit, *, k: int):
    """Replace each island's worst k candidates with its neighbour's best k.

    All tensors carry an (I, phi, ...) leading pair; ``counts`` may be None
    (values-based measures carry none)."""
    I, phi = fit.shape
    order = torch.argsort(-fit, dim=1, stable=True)
    best_i, worst_i = order[:, :k], order[:, phi - k:]
    ai = torch.arange(I, device=fit.device)[:, None]

    def swap(x):
        if x is None:
            return None
        out = x.clone()
        out[ai, worst_i] = torch.roll(_gather_cands(x, best_i), 1, dims=0)
        return out

    return swap(rows), swap(cols), swap(counts), swap(fit)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


class TorchDraws:
    """Makes every random input of the GA with one ``torch.Generator``.

    Draws are made on the generator's device and moved to ``device``; with
    a generator on the run's device (the default) nothing moves and nothing
    syncs.  ``generation()`` returns the provider for one generation (this
    object itself)."""

    def __init__(self, generator: torch.Generator, device):
        self.gen = generator
        self.device = torch.device(device)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.gen.device).to(self.device)

    def _randint(self, high, *shape):
        return torch.randint(0, high, shape, generator=self.gen, device=self.gen.device,
                             dtype=torch.int32).to(self.device)

    def _perm(self, *shape):
        return self._rand(*shape).argsort(dim=-1)

    def init(self, I, phi, N, M, n):
        return {"rows": self._randint(N, I, phi, n), "dedup": self._randint(N, I, phi, n),
                "col_u": self._rand(I, phi, M)}

    def generation(self):
        return self

    def mutate(self, I, phi, N, M, n):
        return {"u_mut": self._rand(I, phi), "u_rc": self._rand(I, phi),
                "slot": self._randint(n, I, phi), "fresh": self._randint(N, I, phi),
                "u_off": self._rand(I, phi, M), "u_on": self._rand(I, phi, M)}

    def cross(self, I, phi, N, M, n, m):
        half = phi // 2
        s_r, s_c = _crossover_splits(self.gen, (I, half), n, m, self.device)
        d = {"perm": self._perm(I, phi), "u_cross": self._rand(I, half),
             "s_r": s_r, "s_c": s_c,
             "pi_a": self._perm(I, half, n), "pi_b": self._perm(I, half, n),
             "fresh_ab": self._randint(N, I, half, n), "fresh_ba": self._randint(N, I, half, n)}
        for name in ("u_ab1", "u_ab2", "u_abf", "u_ba1", "u_ba2", "u_baf"):
            d[name] = self._rand(I, half, M)
        return d

    def select(self, probs: torch.Tensor, k: int) -> torch.Tensor:
        """(I, k) fitness-proportional picks, with replacement."""
        drawn = torch.multinomial(probs.to(self.gen.device), k, replacement=True,
                                  generator=self.gen)
        return drawn.to(self.device)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def _take_first(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading it back to the host."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def _gen_dst_run(codes, values, n: int, m: int, cfg: GenDSTConfig, B: int, target: int, draws):
    """The GA body: init, then ``cfg.psi`` generations, all on the device."""
    N, M = codes.shape
    I, phi = cfg.num_islands, cfg.phi
    dev = codes.device
    entropy = cfg.measure == "entropy"

    if entropy:
        f_ref = full_column_entropy(codes, B).mean()
    else:
        measure_fn = MEASURES[cfg.measure]
        f_ref = measure_fn(values)

    def pop_counts(rows):
        # one launch gathers the candidates' rows and counts them
        return population_histogram_rows(codes, rows.reshape(-1, n), B).reshape(I, phi, M, B)

    no_delta = torch.zeros((I, phi), dtype=torch.float32, device=dev)

    def fitness(rows, cols, counts, applied, old_codes, new_codes):
        if not entropy:
            return None, -(measure_fn(values, rows, cols) - f_ref).abs()
        return fused_delta_fitness(counts, old_codes, new_codes, applied, cols, f_ref)

    rows, cols = _init_population(draws.init(I, phi, N, M, n), N, M, n, m, target)
    counts = pop_counts(rows) if entropy else None
    zero_codes = torch.zeros((I, phi, M), dtype=torch.int32, device=dev)
    counts, fit0 = fitness(rows, cols, counts, no_delta, zero_codes, zero_codes)
    flat0 = fit0.reshape(-1)
    b0 = torch.argmax(flat0)
    best_f = _take_first(flat0, b0)
    best_r = _take_first(rows.reshape(-1, n), b0)
    best_c = _take_first(cols.reshape(-1, M), b0)

    op_kw = dict(N=N, M=M, n=n, m=m, p_rc=cfg.p_rc, target=target)
    k_mig = max(1, int(round(cfg.migrate_frac * phi)))
    n_drawn = phi - _n_elite(phi, cfg.alpha)
    history = []
    for gen_idx in range(cfg.psi):
        g = draws.generation()
        rows1, cols1, applied, old_vals, fresh = _mutate_core(
            g.mutate(I, phi, N, M, n), rows, cols, xi=cfg.xi, **op_kw)
        # which counts and delta feed the fused step: a recompute after
        # crossover (zero delta), or the carried counts and the mutation delta
        if gen_idx % cfg.cross_every == 0:
            rows2, cols2 = _crossover(g.cross(I, phi, N, M, n, m), rows1, cols1, **op_kw)
            counts_b = pop_counts(rows2) if entropy else None
            app = no_delta
        elif not entropy:
            rows2, cols2, counts_b, app = rows1, cols1, None, no_delta
        elif cfg.incremental:
            rows2, cols2, counts_b, app = rows1, cols1, counts, applied.to(torch.float32)
        else:
            rows2, cols2, counts_b, app = rows1, cols1, pop_counts(rows1), no_delta
        counts2, fit = fitness(rows2, cols2, counts_b, app,
                               codes[old_vals.long()], codes[fresh.long()])

        flat = fit.reshape(-1)
        g_best = torch.argmax(flat)
        f_best = _take_first(flat, g_best)
        better = f_best > best_f
        best_f = torch.where(better, f_best, best_f)
        best_r = torch.where(better, _take_first(rows2.reshape(-1, n), g_best), best_r)
        best_c = torch.where(better, _take_first(cols2.reshape(-1, M), g_best), best_c)

        if I > 1 and (gen_idx + 1) % cfg.migrate_every == 0:
            rows2, cols2, counts2, fit = _ring_migrate(rows2, cols2, counts2, fit, k=k_mig)

        keep = _select_idx(fit, g.select(_selection_probs(fit), n_drawn), alpha=cfg.alpha)
        rows, cols = _gather_cands(rows2, keep), _gather_cands(cols2, keep)
        counts = None if counts2 is None else _gather_cands(counts2, keep)
        history.append(best_f)
    hist = torch.stack(history) if history else torch.zeros(0, device=dev)
    return best_r, best_c, best_f, hist, f_ref


def _resolve_nm(coded: CodedDataset, n, m):
    N, M = coded.codes.shape
    dn, dm = default_dst_size(N, M)
    return (dn if n is None else min(n, N)), (dm if m is None else min(m, M))


def _on_device(coded: CodedDataset, device: DeviceLike):
    dev = resolve_device(device)
    return (coded if coded.device == dev else coded.to(dev)), dev


def gen_dst(
    generator: Optional[torch.Generator],
    coded: CodedDataset,
    n: Optional[int] = None,
    m: Optional[int] = None,
    cfg: GenDSTConfig = GenDSTConfig(),
    *,
    device: DeviceLike = None,
    draws=None,
) -> DSTResult:
    """Run Gen-DST on a factorized dataset; returns the best DST found.

    ``generator`` seeds the search (None: seed 0 on the device).  ``draws``
    replaces the generator with another draw provider (the tests replay the
    reference's key splits through it)."""
    coded, dev = _on_device(coded, device)
    n, m = _resolve_nm(coded, n, m)
    _validate_cfg(cfg)
    if draws is None:
        draws = TorchDraws(make_generator(0, dev) if generator is None else generator, dev)
    best_r, best_c, best_f, history, f_ref = _gen_dst_run(
        coded.codes, coded.values, n, m, cfg, coded.max_bins, coded.target_col, draws)
    return DSTResult(best_r, best_c, best_f, history, f_ref)


def random_dst(generator: Optional[torch.Generator], coded: CodedDataset,
               n: Optional[int] = None, m: Optional[int] = None, *,
               device: DeviceLike = None) -> DSTResult:
    """A uniformly random DST (the paper's trivial baseline building block)."""
    coded, dev = _on_device(coded, device)
    n, m = _resolve_nm(coded, n, m)
    N, M = coded.codes.shape
    draws = TorchDraws(make_generator(0, dev) if generator is None else generator, dev)
    rows, cols = _init_population(draws.init(1, 2, N, M, n), N, M, n, m, coded.target_col)
    nan = torch.tensor(float("nan"), device=dev)
    return DSTResult(rows[0, 0], cols[0, 0], nan, torch.zeros(0, device=dev), nan)
