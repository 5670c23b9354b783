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
* **Generations replayed from CUDA graphs.**  One generation is a body that
  reads the carried state (rows, masks, counts, best so far) and returns the
  next, writing its best fitness into the history at a device counter.  On a
  card, from ``GEN_DST_GRAPH_MIN_GENS`` generations on and with every draw
  made by a ``TorchDraws`` on the run's device, each generation kind runs
  once eagerly, is then captured into a CUDA graph that updates the state's
  buffers in place, and is replayed for one launch a generation
  (``_GenerationGraphs``): the same operations and draws in the same order,
  so the same search.  Elsewhere the loop runs eagerly.
* **Batches as islands.**  ``gen_dst_batch`` runs D same-shaped datasets'
  searches as one, where the reference vmaps its jitted search: their
  tables are stacked on the row axis and their islands on the island axis,
  so a generation launches each kernel once whatever D is, and the fused
  kernel reads each candidate's own F(D).  Each dataset's draws come from
  its own provider in its solo order, and migration and selection stay
  within its islands, so each result is bit-equal to its solo run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..device import DeviceLike, capture_resources, make_generator, resolve_device
from ..kernels import add_launches, launch_counts
from ..kernels.entropy.ops import population_histogram_rows
from ..kernels.gen_dst.ops import fused_delta_fitness
from ..obs import trace as _trace
from .measures import MEASURES, CodedDataset, full_column_entropy

__all__ = ["GenDSTConfig", "DSTResult", "TorchDraws", "gen_dst", "gen_dst_batch",
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


def _ring_migrate(rows, cols, counts, fit, *, k: int, groups: int = 1):
    """Replace each island's worst k candidates with its neighbour's best k.

    All tensors carry an (I, phi, ...) leading pair; ``counts`` may be None
    (values-based measures carry none).  With ``groups`` > 1 the islands are
    that many rings of I / groups islands each (one per dataset of a batch),
    and migration stays within each ring."""
    I, phi = fit.shape
    order = torch.argsort(-fit, dim=1, stable=True)
    best_i, worst_i = order[:, :k], order[:, phi - k:]
    ai = torch.arange(I, device=fit.device)[:, None]

    def swap(x):
        if x is None:
            return None
        out = x.clone()
        best = _gather_cands(x, best_i)
        ring = best.reshape((groups, I // groups) + best.shape[1:])
        out[ai, worst_i] = torch.roll(ring, 1, dims=1).reshape(best.shape)
        return out

    return swap(rows), swap(cols), swap(counts), swap(fit)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


class TorchDraws:
    """Makes every random input of the GA, and of the baselines
    (``core/baselines.py``), with one ``torch.Generator``.

    Draws are made on the generator's device and moved to ``device``; with
    a generator on the run's device (the default) nothing moves and nothing
    syncs.  ``generation()`` returns the provider for one generation (this
    object itself).  The baselines draw through ``split``, ``uniform``,
    ``randint``, ``choice`` and ``init``, which mirror the reference's uses
    of one ``jax.random`` key: ``split`` gives the providers of sub-keys,
    which here all draw from the one generator in turn."""

    def __init__(self, generator: torch.Generator, device):
        self.gen = generator
        self.device = torch.device(device)

    def uniform(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.gen.device).to(self.device)

    def randint(self, high, *shape):
        return torch.randint(0, high, shape, generator=self.gen, device=self.gen.device,
                             dtype=torch.int32).to(self.device)

    def _perm(self, *shape):
        return self.uniform(*shape).argsort(dim=-1)

    def split(self, num: int = 2) -> list:
        return [self] * num

    def choice(self, P: int, k: int) -> torch.Tensor:
        """k distinct indices of range(P), int64: a random permutation's
        prefix, as ``jax.random.choice(..., replace=False)`` draws them."""
        perm = torch.randperm(P, generator=self.gen, device=self.gen.device)
        return perm[:k].to(self.device)

    def init(self, I, phi, N, M, n):
        return {"rows": self.randint(N, I, phi, n), "dedup": self.randint(N, I, phi, n),
                "col_u": self.uniform(I, phi, M)}

    def generation(self):
        return self

    def mutate(self, I, phi, N, M, n):
        return {"u_mut": self.uniform(I, phi), "u_rc": self.uniform(I, phi),
                "slot": self.randint(n, I, phi), "fresh": self.randint(N, I, phi),
                "u_off": self.uniform(I, phi, M), "u_on": self.uniform(I, phi, M)}

    def cross(self, I, phi, N, M, n, m):
        half = phi // 2
        s_r, s_c = _crossover_splits(self.gen, (I, half), n, m, self.device)
        d = {"perm": self._perm(I, phi), "u_cross": self.uniform(I, half),
             "s_r": s_r, "s_c": s_c,
             "pi_a": self._perm(I, half, n), "pi_b": self._perm(I, half, n),
             "fresh_ab": self.randint(N, I, half, n), "fresh_ba": self.randint(N, I, half, n)}
        for name in ("u_ab1", "u_ab2", "u_abf", "u_ba1", "u_ba2", "u_baf"):
            d[name] = self.uniform(I, half, M)
        return d

    def select(self, probs: torch.Tensor, k: int) -> torch.Tensor:
        """(I, k) fitness-proportional picks, with replacement."""
        drawn = torch.multinomial(probs.to(self.gen.device), k, replacement=True,
                                  generator=self.gen)
        return drawn.to(self.device)


class _StackedDraws:
    """The draws of D searches run as one, islands stacked dataset by
    dataset: each dataset's provider makes its own islands' draws, in the
    order its solo run makes them."""

    def __init__(self, providers, I: int):
        self.providers, self.I = providers, I

    @staticmethod
    def _cat(parts) -> dict:
        return {name: torch.cat([p[name] for p in parts]) for name in parts[0]}

    def init(self, *shape):
        return self._cat([p.init(*shape) for p in self.providers])

    def generation(self):
        return _StackedDraws([p.generation() for p in self.providers], self.I)

    def mutate(self, *shape):
        return self._cat([p.mutate(*shape) for p in self.providers])

    def cross(self, *shape):
        return self._cat([p.cross(*shape) for p in self.providers])

    def select(self, probs: torch.Tensor, k: int) -> torch.Tensor:
        I = self.I
        return torch.cat([p.select(probs[d * I:(d + 1) * I], k)
                          for d, p in enumerate(self.providers)])


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def _entropy_fitness(codes, B: int, f_ref, rows, cols) -> torch.Tensor:
    """(..., phi) fitness of candidates with rows (..., phi, n) and masks
    (..., phi, M): their histograms by the masked-histogram kernel (B1, which
    gathers the rows), reduced by the fused kernel (B2) with a zero delta,
    as Gen-DST's initial population is scored (the reference's
    ``_entropy_fitness``, ``gen_dst.py:169``)."""
    lead, n, M = rows.shape[:-1], rows.shape[-1], codes.shape[1]
    counts = population_histogram_rows(codes, rows.reshape(-1, n), B).reshape(lead + (M, B))
    zero_codes = torch.zeros(lead + (M,), dtype=torch.int32, device=codes.device)
    no_delta = torch.zeros(lead, dtype=torch.float32, device=codes.device)
    return fused_delta_fitness(counts, zero_codes, zero_codes, no_delta, cols, f_ref)[1]


# From this many generations on, a search on a card replays its generations
# from CUDA graphs; below it, the eager loop.  The capture costs about one
# eager generation of host time and the graph's instantiation more: on an
# H100, whole searches (to the rows on the host, medians of 15) at D1's, D6's
# and the smallest many-models partition's tables took 11.8, 13.4 and 14.5 ms
# graphed against 8.4, 10.5 and 10.8 eager at 2 generations; 14.9, 13.3 and
# 13.1 against 14.8, 16.5 and 13.0 at 3; 15.5, 13.1 and 13.7 against 22.7,
# 17.4 and 18.7 at 4; and 30.7, 29.2 and 30.2 against 130.1, 137.0 and 134.2
# at the paper's 30.
GEN_DST_GRAPH_MIN_GENS = 4


def _on_cuda(d: torch.device, dev: torch.device) -> bool:
    """Whether ``d`` is the CUDA device ``dev`` (which carries its index)."""
    return d.type == "cuda" and (
        d.index if d.index is not None else torch.cuda.current_device()) == dev.index


def _graph_generators(cfg: GenDSTConfig, dev: torch.device, draws) -> Optional[list]:
    """The generators a search's CUDA graphs register, or None where the
    search runs the eager loop: off a card, inside another capture, for a
    measure other than entropy (its fitness is no kernel of the port), below
    ``GEN_DST_GRAPH_MIN_GENS`` generations, or where a draw provider is not a
    ``TorchDraws`` whose generator is on the run's device (a capture would
    freeze another provider's draws, or a CPU generator's, into constants)."""
    if (dev.type != "cuda" or cfg.measure != "entropy" or cfg.psi < GEN_DST_GRAPH_MIN_GENS
            or torch.cuda.is_current_stream_capturing()):
        return None
    providers = draws.providers if type(draws) is _StackedDraws else [draws]
    gens = []
    for p in providers:
        if not (type(p) is TorchDraws and _on_cuda(p.device, dev) and _on_cuda(p.gen.device, dev)):
            return None
        if all(g is not p.gen for g in gens):
            gens.append(p.gen)
    return gens


class _GenerationGraphs:
    """The CUDA graphs of one search's generations, one per generation kind
    (whether it crosses, whether it migrates): at most four, and one at the
    paper's defaults.  A kind's first generation runs eagerly (``seen``
    holds the kinds that did); its next is captured on this thread's side
    stream into the shared pool (``device.capture_resources``) and replayed
    on the caller's stream, as is every later one.  Each graph registers the
    search's generators, so a replay advances them as the eager generation
    would, and draws what it would draw.  The graphs are freed with this
    object, when the search returns; launches still queued finish first."""

    def __init__(self, dev: torch.device, generators: list):
        self.dev, self.generators = dev, generators
        self.side, self.holder = capture_resources(dev)
        self.seen, self.graphs = set(), {}

    def replay(self, kind, body) -> None:
        """One generation of ``kind`` from its graph, captured from ``body``
        first if it has none; the kernel launch counters rise by the
        launches the graph holds."""
        if kind not in self.graphs:
            self.graphs[kind] = self._capture(body)
        graph, held = self.graphs[kind]
        graph.replay()
        add_launches(held)

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        caller = torch.cuda.current_stream(self.dev)
        self.side.wait_stream(caller)
        before = launch_counts()
        with torch.cuda.stream(self.side):
            graph.capture_begin(pool=self.holder.pool(), capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        caller.wait_stream(self.side)
        held = {name: n - before[name] for name, n in launch_counts().items()
                if n != before[name]}
        add_launches({name: -n for name, n in held.items()})   # a capture launches nothing
        return graph, held


def _gen_dst_run(codes, values, N: int, n: int, m: int, cfg: GenDSTConfig, B: int, target: int,
                 draws):
    """The GA body for D same-shaped datasets stacked on the row axis (codes
    and values (D*N, M)): init, then ``cfg.psi`` generations, all on the
    device.  Dataset d's I islands are islands d*I .. d*I + I - 1 of one
    population, so each generation launches B1 and B2 once whatever D is;
    row indices stay in [0, N) and are offset by d*N where they read the
    table.  Returns per dataset: best rows (D, n), masks (D, M), fitness
    (D,), history (D, psi) and F(D) (D,).  Records a ``gen_dst.init`` span
    and one ``gen_dst.generation`` span a generation (attrs ``gen``, and
    ``gen_graphed``: 1 where a graph's replay ran it, 0 where it ran
    eagerly): each covers the issuing of its work (a capture included), and
    nothing waits for the device."""
    M = codes.shape[1]
    D = codes.shape[0] // N
    I, phi = cfg.num_islands, cfg.phi
    G = D * I                                    # islands of all datasets
    dev = codes.device
    entropy = cfg.measure == "entropy"

    def in_table(idx):
        """(G, phi, ...) row indices as rows of the stacked table."""
        if offset is None:
            return idx
        return idx + offset.reshape((G,) + (1,) * (idx.dim() - 1))

    def pop_counts(rows):
        # one launch gathers the candidates' rows and counts them
        return population_histogram_rows(codes, in_table(rows).reshape(-1, n), B).reshape(
            G, phi, M, B)

    def fitness(rows, cols, counts, applied, old_codes, new_codes):
        if not entropy:
            return None, -(measure_fn(values, in_table(rows), cols) - f_cand).abs()
        return fused_delta_fitness(counts, old_codes, new_codes, applied, cols, f_cand)

    def best_of(fit, rows, cols):
        """Each dataset's best candidate: fitness (D,), rows (D, n), mask (D, M)."""
        flat = fit.reshape(D, I * phi)
        g = flat.argmax(1, keepdim=True)
        return (flat.gather(1, g)[:, 0],
                rows.reshape(D, I * phi, n).gather(1, g[..., None].expand(D, 1, n))[:, 0],
                cols.reshape(D, I * phi, M).gather(1, g[..., None].expand(D, 1, M))[:, 0])

    with _trace.span(None, None, "gen_dst.init"):
        parts = [slice(d * N, (d + 1) * N) for d in range(D)]
        if entropy:
            f_refs = [full_column_entropy(codes[p], B).mean() for p in parts]
        else:
            measure_fn = MEASURES[cfg.measure]
            f_refs = [measure_fn(values[p]) for p in parts]
        if D == 1:
            f_ref = f_cand = f_refs[0]
            offset = None
        else:
            # one F(D) per candidate, and each island's row offset in the table
            f_ref = torch.stack(f_refs)
            f_cand = f_ref[:, None, None].expand(D, I, phi).reshape(G, phi)
            offset = (torch.arange(D, device=dev, dtype=torch.int32) * N)[:, None].expand(
                D, I).reshape(G, 1)

        no_delta = torch.zeros((G, phi), dtype=torch.float32, device=dev)
        rows, cols = _init_population(draws.init(I, phi, N, M, n), N, M, n, m, target)
        counts = pop_counts(rows) if entropy else None
        zero_codes = torch.zeros((G, phi, M), dtype=torch.int32, device=dev)
        counts, fit0 = fitness(rows, cols, counts, no_delta, zero_codes, zero_codes)
        best_f, best_r, best_c = best_of(fit0, rows, cols)

    op_kw = dict(N=N, M=M, n=n, m=m, p_rc=cfg.p_rc, target=target)
    k_mig = max(1, int(round(cfg.migrate_frac * phi)))
    n_drawn = phi - _n_elite(phi, cfg.alpha)
    # the carried state, and each generation's best fitness written at the
    # device counter k
    state = [rows, cols, counts, best_f, best_r, best_c]
    hist = torch.zeros((D, cfg.psi), dtype=best_f.dtype, device=dev)
    k = torch.zeros((1,), dtype=torch.int64, device=dev)

    def generation(cross: bool, migrate: bool) -> list:
        """One generation from ``state``: returns the next state, and writes
        the generation's best fitness into ``hist`` at ``k``."""
        rows, cols, counts, best_f, best_r, best_c = state
        g = draws.generation()
        rows1, cols1, applied, old_vals, fresh = _mutate_core(
            g.mutate(I, phi, N, M, n), rows, cols, xi=cfg.xi, **op_kw)
        # which counts and delta feed the fused step: a recompute after
        # crossover (zero delta), or the carried counts and the mutation delta
        if cross:
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
                               codes[in_table(old_vals).long()], codes[in_table(fresh).long()])

        f_best, r_best, c_best = best_of(fit, rows2, cols2)
        better = f_best > best_f
        best_f = torch.where(better, f_best, best_f)
        best_r = torch.where(better[:, None], r_best, best_r)
        best_c = torch.where(better[:, None], c_best, best_c)

        if migrate:
            rows2, cols2, counts2, fit = _ring_migrate(rows2, cols2, counts2, fit, k=k_mig,
                                                       groups=D)

        keep = _select_idx(fit, g.select(_selection_probs(fit), n_drawn), alpha=cfg.alpha)
        hist.index_copy_(1, k, best_f[:, None])
        k.add_(1)
        return [_gather_cands(rows2, keep), _gather_cands(cols2, keep),
                None if counts2 is None else _gather_cands(counts2, keep),
                best_f, best_r, best_c]

    def into_state(new):
        for buf, x in zip(state, new):
            if buf is not None:
                buf.copy_(x)

    gens = _graph_generators(cfg, dev, draws)
    graphs = None if gens is None else _GenerationGraphs(dev, gens)
    for gen_idx in range(cfg.psi):
        kind = (gen_idx % cfg.cross_every == 0,
                I > 1 and (gen_idx + 1) % cfg.migrate_every == 0)
        replay = graphs is not None and kind in graphs.seen
        with _trace.span(None, None, "gen_dst.generation", gen=gen_idx,
                         gen_graphed=int(replay)):
            if replay:
                graphs.replay(kind, lambda: into_state(generation(*kind)))
            elif graphs is None:
                state = generation(*kind)
            else:
                # the graphs read and write the state's buffers in place
                into_state(generation(*kind))
                graphs.seen.add(kind)
    best_f, best_r, best_c = state[3:]
    return best_r, best_c, best_f, hist, f_ref.reshape(D)


def _resolve_nm(coded: CodedDataset, n, m):
    N, M = coded.codes.shape
    dn, dm = default_dst_size(N, M)
    return (dn if n is None else min(n, N)), (dm if m is None else min(m, M))


def _on_device(coded: CodedDataset, device: DeviceLike):
    dev = resolve_device(device)
    return (coded if coded.device == dev else coded.to(dev)), dev


def _default_draws(generator: Optional[torch.Generator], dev) -> TorchDraws:
    """Draws from ``generator``, or from seed 0 on the device."""
    return TorchDraws(make_generator(0, dev) if generator is None else generator, dev)


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
        draws = _default_draws(generator, dev)
    best_r, best_c, best_f, history, f_ref = _gen_dst_run(
        coded.codes, coded.values, coded.num_rows, n, m, cfg, coded.max_bins,
        coded.target_col, draws)
    return DSTResult(best_r[0], best_c[0], best_f[0], history[0], f_ref[0])


def gen_dst_batch(
    generators: Sequence[Optional[torch.Generator]],
    codeds: Sequence[CodedDataset],
    n: Optional[int] = None,
    m: Optional[int] = None,
    cfg: GenDSTConfig = GenDSTConfig(),
    *,
    device: DeviceLike = None,
    draws=None,
) -> list:
    """Run Gen-DST on several same-shaped datasets as one search.

    ``generators``/``codeds`` are parallel sequences; every dataset must
    share the ``codes`` shape, ``max_bins`` and ``target_col``.  The D
    searches are independent: their islands are stacked into one population
    (D x ``num_islands`` islands), so each generation launches each kernel
    once for all of them, while migration and selection stay within each
    dataset's islands.  Each result is bit-equal to a solo ``gen_dst`` with
    the same generator.  ``draws``, when given, is one draw provider per
    dataset."""
    if len(generators) != len(codeds) or not codeds:
        raise ValueError("gen_dst_batch: generators and codeds must be equal-length"
                         " non-empty sequences")
    c0 = codeds[0]
    for c in codeds[1:]:
        if (c.codes.shape != c0.codes.shape or c.max_bins != c0.max_bins
                or c.target_col != c0.target_col):
            raise ValueError("gen_dst_batch: all datasets must share the "
                             "codes shape, max_bins, and target_col")
    dev = resolve_device(device)
    n, m = _resolve_nm(c0, n, m)
    _validate_cfg(cfg)
    if draws is None:
        draws = [_default_draws(g, dev) for g in generators]
    elif len(draws) != len(codeds):
        raise ValueError("gen_dst_batch: one draw provider per dataset")
    best_r, best_c, best_f, history, f_ref = _gen_dst_run(
        torch.cat([c.codes.to(dev) for c in codeds]),
        torch.cat([c.values.to(dev) for c in codeds]),
        c0.num_rows, n, m, cfg, c0.max_bins, c0.target_col,
        _StackedDraws(list(draws), cfg.num_islands))
    return [DSTResult(best_r[d], best_c[d], best_f[d], history[d], f_ref[d])
            for d in range(len(codeds))]


def random_dst(generator: Optional[torch.Generator], coded: CodedDataset,
               n: Optional[int] = None, m: Optional[int] = None, *,
               device: DeviceLike = None) -> DSTResult:
    """A uniformly random DST (the paper's trivial baseline building block)."""
    coded, dev = _on_device(coded, device)
    n, m = _resolve_nm(coded, n, m)
    N, M = coded.codes.shape
    draws = _default_draws(generator, dev)
    rows, cols = _init_population(draws.init(1, 2, N, M, n), N, M, n, m, coded.target_col)
    nan = torch.tensor(float("nan"), device=dev)
    return DSTResult(rows[0, 0], cols[0, 0], nan, torch.zeros(0, device=dev), nan)
