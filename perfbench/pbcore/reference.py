"""The plain reference the benchmark holds the program's answers to.

Plain NumPy and PyTorch.  It imports nothing of the program, and it takes
nothing the program made but the answers it judges (the subset, the trial
log, the winner's spec and parameters, the reported accuracies).  Whatever
the program derived from its inputs it works out again here: the coded
table, the entropies, the AutoML engine's split, population, pipelines,
initial parameters and training.

Each piece is a frozen copy of the definition the port states, with the
file it follows named beside it:

* ``factorize``: ``src/repro_torch/core/measures.py`` (``factorize``).
* ``dst_fitness``: ``src/repro_torch/kernels/entropy/ref.py``
  (``entropy_bits64``) and ``src/repro_torch/core/gen_dst.py`` (fitness
  ``-|F(d) - F(D)|``, F the mean column entropy).
* ``build_subset``: ``src/repro_torch/core/substrat.py``.
* The AutoML replay: ``src/repro_torch/automl/engine.py`` (split, spec
  sampling, preprocessing, feature selection, per-trial seed) and
  ``src/repro_torch/automl/models.py`` (families, losses, ``adam_train``).

``precision`` chooses how the reference computes: ``"float32"`` (the
configuration's own precision: float32 matmuls with TF32 off, entropies
summed in float64) or ``"lower"`` (the control: matmuls in TF32, float32
binning and entropy sums).  TF32 is emulated by rounding every operand of a
product, forward and backward, to 10 mantissa bits and accumulating in
float32, as the tensor cores do; so the control is the same on any device.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PREPROCS = ("none", "standardize", "minmax")
FEATURE_FRACS = (1.0, 0.5)
# (family, its HP grid) in the engine's order: the spec draws depend on it
FAMILY_GRIDS = (
    ("logreg", {"lr": (0.3, 0.1, 0.03), "l2": (0.0, 1e-4, 1e-2)}),
    ("mlp", {"lr": (0.01, 0.003, 0.001), "l2": (0.0, 1e-4), "width": (32, 64, 128),
             "depth": (1, 2)}),
    ("linear_svm", {"lr": (0.1, 0.03, 0.01), "l2": (1e-4, 1e-2)}),
    ("gnb", {"var_smoothing": (1e-9, 1e-6, 1e-3)}),
    ("centroid", {"shrinkage": (0.0, 0.2, 0.5)}),
)
GRIDS = dict(FAMILY_GRIDS)
CLOSED_FORM = ("gnb", "centroid")


# ---------------------------------------------------------------------------
# factorize and the DST fitness
# ---------------------------------------------------------------------------


def factorize(X: np.ndarray, y: np.ndarray, precision: str = "float32",
              max_bins: int = 256, categorical_threshold: int = 64):
    """(codes (N, M+1) int32, n_bins (M+1,) int32, target_col, max_bins):
    exact codes for columns of few distinct values and the target, quantile
    bins for the others.  The configuration bins in float64; the control in
    float32."""
    ftype = np.float64 if precision == "float32" else np.float32
    cols = [np.asarray(X[:, j]) for j in range(X.shape[1])] + [np.asarray(y)]
    N = X.shape[0]
    codes = np.empty((N, len(cols)), dtype=np.int32)
    n_bins = np.empty((len(cols),), dtype=np.int32)
    for j, col in enumerate(cols):
        colf = col.astype(ftype)
        uniq, inv = np.unique(colf, return_inverse=True)
        if len(uniq) <= max(categorical_threshold, 2) or j == len(cols) - 1:
            codes[:, j] = inv.astype(np.int32)
            n_bins[j] = len(uniq)
        else:
            qs = np.quantile(colf, np.linspace(0.0, 1.0, max_bins + 1)[1:-1]).astype(ftype)
            binned = np.searchsorted(qs, colf, side="right")
            uniq_b, inv_b = np.unique(binned, return_inverse=True)
            codes[:, j] = inv_b.astype(np.int32)
            n_bins[j] = len(uniq_b)
    return codes, n_bins, len(cols) - 1, int(max(int(n_bins.max()), 2))


def _column_entropy(codes: np.ndarray, B: int, dtype) -> np.ndarray:
    """Shannon entropy (bits) of each column's histogram, summed in ``dtype``."""
    n, M = codes.shape
    counts = np.zeros((M, B), dtype=dtype)
    for j in range(M):
        counts[j] = np.bincount(codes[:, j], minlength=B)[:B]
    p = counts / np.maximum(counts.sum(-1, keepdims=True), dtype(1e-12))
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, p * np.log2(np.maximum(p, dtype(1e-30))), dtype(0))
    return -terms.sum(-1, dtype=dtype)


def dst_fitness(codes: np.ndarray, B: int, rows: np.ndarray, col_mask: np.ndarray,
                precision: str = "float32") -> float:
    """-|F(d) - F(D)| of the subset (rows, columns by mask)."""
    dtype = np.float64 if precision == "float32" else np.float32
    f_full = _column_entropy(codes, B, dtype).mean(dtype=dtype)
    h_sub = _column_entropy(codes[np.asarray(rows, np.int64)], B, dtype)
    cm = np.asarray(col_mask, dtype)
    f_sub = (h_sub * cm).sum(dtype=dtype) / max(cm.sum(dtype=dtype), dtype(1))
    return float(-abs(f_sub - f_full))


def build_subset(X, y, row_idx, col_idx, patch_seed_source: int):
    """The sub-AutoML's training rows: the subset's rows and feature columns,
    patched with rows of each class the subset misses (at most
    ``len(row_idx) // len(missing)`` and 32 each); the patch's numpy seed is
    one draw from a CPU generator seeded with ``patch_seed_source``."""
    X, y = np.asarray(X), np.asarray(y)
    X_sub, y_sub = X[row_idx][:, col_idx], y[row_idx]
    missing = np.setdiff1d(np.unique(y), np.unique(y_sub))
    if len(missing):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(patch_seed_source))
        seed = int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=gen)[0])
        rng = np.random.default_rng(seed)
        per_class = max(1, len(row_idx) // len(missing))
        extra = np.concatenate([
            rng.choice(np.flatnonzero(y == cls), size=min(32, per_class, int((y == cls).sum())),
                       replace=False)
            for cls in missing])
        X_sub = np.concatenate([X_sub, X[extra][:, col_idx]])
        y_sub = np.concatenate([y_sub, y[extra]])
    return X_sub, y_sub


# ---------------------------------------------------------------------------
# products: float32 with TF32 off, or TF32 (the control)
# ---------------------------------------------------------------------------


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (round to nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).mT, to_tf32(a).mT @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return a @ b if precision == "float32" else _TF32MatMul.apply(a, b)


# ---------------------------------------------------------------------------
# the AutoML engine, one trial at a time
# ---------------------------------------------------------------------------


def spec_key(spec) -> tuple:
    """A pipeline spec as a plain tuple (preproc, feature_frac, family, hp)."""
    return (spec.preproc, float(spec.feature_frac), spec.family, tuple(spec.hp))


def sample_specs(rng: np.random.Generator, n: int, families: Sequence[str]) -> List[tuple]:
    """The engine's population: ``n`` draws, duplicates dropped in order."""
    specs = []
    for _ in range(n):
        fam = families[rng.integers(len(families))]
        hp = tuple(sorted((k, v[rng.integers(len(v))]) for k, v in GRIDS[fam].items()))
        pre = PREPROCS[rng.integers(len(PREPROCS))]
        frac = FEATURE_FRACS[rng.integers(len(FEATURE_FRACS))]
        specs.append((pre, float(frac), fam, hp))
    seen, out = set(), []
    for s in specs:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def trial_seed(seed: int, trial_id: int, rung_i: int) -> int:
    digest = hashlib.blake2s(f"{seed}/{trial_id}/{rung_i}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _fit_preproc(name: str, X: np.ndarray) -> Dict[str, np.ndarray]:
    if name == "standardize":
        return {"mu": X.mean(0), "sd": X.std(0) + 1e-9}
    if name == "minmax":
        return {"lo": X.min(0), "hi": X.max(0)}
    return {}


def _apply_preproc(name: str, stats, X: np.ndarray) -> np.ndarray:
    if name == "standardize":
        return (X - stats["mu"]) / stats["sd"]
    if name == "minmax":
        rng = np.maximum(stats["hi"] - stats["lo"], 1e-9)
        return (X - stats["lo"]) / rng * 2.0 - 1.0
    return X


def _select_features(frac: float, X_train: np.ndarray) -> np.ndarray:
    d = X_train.shape[1]
    k = max(1, int(round(frac * d)))
    if k >= d:
        return np.arange(d)
    return np.argsort(-X_train.var(axis=0))[:k]


def _xent(logits, y):
    return -F.log_softmax(logits, dim=-1).gather(-1, y[:, None])[:, 0].mean()


def _hinge(logits, y):
    margins = (logits - logits.gather(-1, y[:, None]) + 1.0).clamp_min(0.0)
    own = y[:, None] == torch.arange(logits.shape[-1], device=y.device)
    return torch.where(own, 0.0, margins).sum(-1).mean()


def predict(family: str, params, X, precision: str):
    if family in ("logreg", "linear_svm"):
        return matmul(X, params["w"], precision) + params["b"]
    if family == "mlp":
        h, layers = X, params["layers"]
        for i, lyr in enumerate(layers):
            h = matmul(h, lyr["w"], precision) + lyr["b"]
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h
    if family == "gnb":
        mu, var, prior = params["mean"], params["var"], params["prior"]
        ll = -0.5 * (((X[:, None, :] - mu[None]) ** 2) / var[None]
                     + torch.log(2 * torch.pi * var)[None]).sum(-1)
        return ll + prior[None]
    if family == "centroid":
        return -((X[:, None, :] - params["cent"][None]) ** 2).sum(-1)
    raise ValueError(family)


def _loss(family, params, X, y, hp, precision):
    logits = predict(family, params, X, precision)
    if family == "linear_svm":
        return _hinge(logits, y) + hp["l2"] * (params["w"] ** 2).sum()
    if family == "mlp":
        return _xent(logits, y) + hp["l2"] * sum((l["w"] ** 2).sum() for l in params["layers"])
    return _xent(logits, y) + hp["l2"] * (params["w"] ** 2).sum()


def leaves(tree) -> list:
    """Leaves in the port's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _rebuild(tree, flat):
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)

    return go(tree)


def _adam(family, params0, X, y, hp, epochs, precision):
    """Full-batch Adam, ``epochs`` steps (b1 0.9, b2 0.999, eps 1e-8; bias
    corrections as float32 tensors)."""
    flat = [p.detach().clone() for p in leaves(params0)]
    dev = flat[0].device
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    t = torch.arange(1, epochs + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.full((), 0.9, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.full((), 0.999, dtype=torch.float32, device=dev), t)
    lr = hp["lr"]
    for i in range(epochs):
        cur = [x.requires_grad_(True) for x in flat]
        loss = _loss(family, _rebuild(params0, cur), X, y, hp, precision)
        grads = torch.autograd.grad(loss, cur)
        with torch.no_grad():
            m = [0.9 * mi + 0.1 * gi for mi, gi in zip(m, grads)]
            v = [0.999 * vi + 0.001 * gi ** 2 for vi, gi in zip(v, grads)]
            flat = [fi - lr * (mi / bc1[i]) / (torch.sqrt(vi / bc2[i]) + 1e-8)
                    for fi, mi, vi in zip(flat, m, v)]
    return _rebuild(params0, [x.detach() for x in flat])


def train(family: str, hp: dict, X, y, c: int, epochs: int, seed: int, precision: str):
    """One trial: the closed-form fit, or Adam from the family's init (MLP:
    He-normal draws from a generator on ``X``'s device seeded with ``seed``,
    layer by layer)."""
    dev = X.device
    if family in CLOSED_FORM:
        onehot = (y[:, None] == torch.arange(c, device=dev)).to(torch.float32)
        cnt = onehot.sum(0)[:, None]
        mean = matmul(onehot.mT, X, precision) / cnt.clamp_min(1.0)
        if family == "centroid":
            overall = X.mean(0, keepdim=True)
            return {"cent": overall + (mean - overall) * (1.0 - hp["shrinkage"])}
        sq = matmul(onehot.mT, X ** 2, precision) / cnt.clamp_min(1.0)
        var = (sq - mean ** 2).clamp_min(0.0) + hp["var_smoothing"]
        prior = torch.log((cnt[:, 0] / X.shape[0]).clamp_min(1e-12))
        return {"mean": mean, "var": var, "prior": prior}
    d = X.shape[1]
    if family == "mlp":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        width, depth = int(hp["width"]), int(hp["depth"])
        dims = [d] + [width] * depth + [c]
        params0 = {"layers": [
            {"w": torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev)
             * (2.0 / dims[i]) ** 0.5,
             "b": torch.zeros((dims[i + 1],), device=dev)}
            for i in range(len(dims) - 1)]}
    else:
        params0 = {"w": torch.zeros((d, c), device=dev), "b": torch.zeros((c,), device=dev)}
    return _adam(family, params0, X, y, hp, epochs, precision)


def n_correct(family: str, params, X, y, precision: str) -> int:
    with torch.no_grad():
        return int((predict(family, params, X, precision).argmax(-1) == y).sum())


def params_gap(prog, ref) -> float:
    """The widest gap of one leaf: ||p - r|| over the larger of ||r|| and the
    median leaf's ||r||.  Leaves that do not line up read infinity."""
    lp, lr = leaves(prog), leaves(ref)
    if len(lp) != len(lr) or any(tuple(a.shape) != tuple(b.shape) for a, b in zip(lp, lr)):
        return math.inf
    norms = [float(torch.linalg.vector_norm(b.double())) for b in lr]
    floor = float(np.median(norms))
    gaps = [float(torch.linalg.vector_norm(a.double().to(b.device) - b.double()))
            / max(nb, floor, 1e-30) for a, b, nb in zip(lp, lr, norms)]
    return max(gaps)


class Pass:
    """One AutoML pass worked out again: the engine's split, population and
    pipelines from its config, on ``device``."""

    def __init__(self, X, y, cfg: dict, restrict_family: Optional[str], device,
                 X_test=None, y_test=None):
        X = np.asarray(X, dtype=np.float32)
        self.classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
        self.c = len(self.classes)
        self.cfg, self.device = cfg, device
        rng = np.random.default_rng(int(cfg["seed"]))
        perm = rng.permutation(X.shape[0])
        n_val = max(1, int(float(cfg["val_frac"]) * X.shape[0]))
        val_idx, tr_idx = perm[:n_val], perm[n_val:]
        self.X_tr, self.y_tr = X[tr_idx], y_enc[tr_idx]
        self.X_val, self.y_val = X[val_idx], y_enc[val_idx]
        families = [restrict_family] if restrict_family else [f for f, _ in FAMILY_GRIDS]
        n_trials = int(cfg["n_trials"])
        n_seed = n_trials if not restrict_family else max(4, n_trials // 4)
        self.specs = sample_specs(rng, n_seed, families)
        self.index = {s: i for i, s in enumerate(self.specs)}
        self.X_test = None if X_test is None else np.asarray(X_test, np.float32)
        self.y_test = None if y_test is None else np.searchsorted(self.classes, np.asarray(y_test))
        self._pipes = {}

    def rung_sizes(self) -> List[int]:
        sizes, n = [], len(self.specs)
        for _ in self.cfg["rungs"]:
            sizes.append(n)
            n = max(1, int(math.ceil(n * float(self.cfg["keep_frac"]))))
        return sizes

    def pipe(self, pre: str, frac: float):
        """(train, val, test) features of one pipeline on the device."""
        key = (pre, frac)
        if key not in self._pipes:
            stats = _fit_preproc(pre, self.X_tr)
            fidx = _select_features(frac, self.X_tr)

            def dev(a):
                if a is None:
                    return None
                return torch.as_tensor(np.ascontiguousarray(
                    _apply_preproc(pre, stats, a)[:, fidx], dtype=np.float32), device=self.device)

            self._pipes[key] = (dev(self.X_tr), dev(self.X_val), dev(self.X_test))
        return self._pipes[key]

    def labels(self, which: str):
        y = {"tr": self.y_tr, "val": self.y_val, "test": self.y_test}[which]
        return torch.as_tensor(y, dtype=torch.int64, device=self.device)

    def train_trial(self, spec: tuple, rung_i: int, precision: str):
        pre, frac, fam, hp = spec
        X_tr, _, _ = self.pipe(pre, frac)
        seed = trial_seed(int(self.cfg["seed"]), self.index[spec], rung_i)
        return train(fam, dict(hp), X_tr, self.labels("tr"), self.c,
                     int(self.cfg["rungs"][rung_i]), seed, precision)

    def correct(self, spec: tuple, params, which: str, precision: str = "float32") -> int:
        pre, frac, fam, _ = spec
        X = self.pipe(pre, frac)[1 if which == "val" else 2]
        return n_correct(fam, params, X, self.labels(which), precision)
