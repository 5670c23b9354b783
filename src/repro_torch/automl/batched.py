"""Batched cohort trainer of the AutoML engine in PyTorch (DESIGN.md §10.3).

The port of the JAX package's ``automl/batched.py``, function by function.
The loop backend (``engine._eval_rung_loop``) trains one trial at a time,
each Adam step a handful of small launches issued by the host.  This module
advances a whole successive-halving rung cohort at once:

- **Pipelines as gathers.**  Each distinct ``(preproc, frac)`` pair becomes
  one full-width data *variant*: the preprocessor applied to all ``d``
  columns, non-selected columns zeroed (zero columns are inert for every
  family, so this matches the loop's column slicing).  Variants stack once
  into a ``(V, N, d)`` tensor on the device; each trial carries a variant id
  and a sub-batch gathers its trials' rows with one index.
- **Stacked params.**  Trials group by ``(family,) + shape_hps``.  Small
  cohorts (``N <= WIDTH_PAD_MAX_ROWS``) pad MLP widths to the sub-batch
  maximum; large ones split per width.  Within a sub-batch every param leaf
  stacks with a leading trial axis ``T`` and the families' functions
  (``models.py``) run on the stack as batched matmuls.  The loss is the sum
  of the trials' losses: their params are disjoint, so one
  ``torch.autograd.grad`` gives every trial exactly its own gradient.  MLP
  inits are drawn at the loop backend's exact shapes from the loop
  backend's ``_trial_generator(seed, trial_id, rung)`` (or the context's
  ``init_provider``) and scattered into the padded layout.
- **One host sync per rung.**  Every input of the rung goes to the device
  before the first sub-batch runs (``_rung_inputs``); the sub-batches then
  queue their work with nothing that waits for the host, and the rung's
  accuracies come back in one copy (``_unpack_results``).  Gradient
  sub-batches take one Adam step per epoch, so the host issues (gradient
  sub-batches x epochs) steps per rung where the loop issues (gradient
  trials x epochs).  With a wall-clock budget active each sub-batch is
  waited for, so the cutoff lands between sub-batches.

Padding is inert (DESIGN.md §10.4): padded MLP units start at zero and
ReLU's backward gives them zero gradient; non-selected columns are zero, so
their first-layer weights get zero gradient; Adam's ``0 / (sqrt(0) + 1e-8)``
keeps padded entries at zero.  Winner params are unpadded back to the loop
backend's shapes, lazily (``engine.search_result`` calls the thunk).

**Cross-job merges** (DESIGN.md §11.4, §12.3, §13): every trial is tagged
with its job slot and gathers its own job's variant and labels.
``eval_rung_cohorts`` runs several jobs' cohorts at the same rung in one
pass (padded to the largest shape, with row and class masks, where their
shapes differ); ``eval_trial_megabatch`` also merges cohorts at different
rungs, each trial carrying its own rung cursor (its MLP init) and step
budget (``models.adam_train``'s step mask).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..obs import trace as _trace
from .engine import (
    TrialCohort, _apply_preproc, _fit_preproc, _select_features, _trial_generator,
)
from .models import (
    CLASS_MASK_NEG, FAMILIES, _leaves, _rebuild, adam_train, masked_accuracy, masked_fit,
    masked_loss,
)

__all__ = ["eval_rung_batched", "eval_rung_cohorts", "eval_trial_megabatch"]


def _tree_map(fn, tree):
    return _rebuild(tree, [fn(x) for x in _leaves(tree)])


def _tree_stack(trees):
    return _rebuild(trees[0], [torch.stack(xs) for xs in zip(*map(_leaves, trees))])


# ---------------------------------------------------------------------------
# pipeline variants: (preproc, feature_frac) -> full-width transformed data
# ---------------------------------------------------------------------------


def _variant(ctx, preproc: str, frac: float) -> int:
    """Ensure the (preproc, frac) variant exists; return its stable index.

    A variant keeps all ``d`` columns — non-selected ones zeroed — so every
    trial shares one array shape and a sub-batch gathers by index."""
    cache = ctx["variant_cache"]
    vkey = (preproc, frac)
    if vkey not in cache:
        X_tr, y_tr, X_val = ctx["X_tr"], ctx["y_tr"], ctx["X_val"]
        stats = _fit_preproc(preproc, X_tr)
        fidx = _select_features(frac, X_tr, y_tr)
        mask = np.zeros((X_tr.shape[1],), np.float32)
        mask[fidx] = 1.0
        cache[vkey] = {
            "id": len(cache),
            "stats": stats,
            "fidx": fidx,
            "fidx_t": torch.as_tensor(fidx, dtype=torch.int64, device=ctx["device"]),
            "Xtr": _apply_preproc(preproc, stats, X_tr) * mask,
            "Xval": _apply_preproc(preproc, stats, X_val) * mask,
        }
        ctx.pop("variant_stack", None)   # invalidate the stacked tensor
    return cache[vkey]["id"]


def _variant_stack(ctx):
    """(V, N, d) / (V, Nval, d) stacked variants on the device, rebuilt only
    on growth."""
    if "variant_stack" not in ctx:
        vs = sorted(ctx["variant_cache"].values(), key=lambda v: v["id"])
        ctx["variant_stack"] = tuple(
            torch.as_tensor(np.stack([v[k] for v in vs]), dtype=torch.float32,
                            device=ctx["device"])
            for k in ("Xtr", "Xval"))
    return ctx["variant_stack"]


def _concat_padded(parts, N_to: int, d_to: int):
    """Merge per-job variant stacks into one (ΣV, N, d) tensor, zero-padding
    each part to the group-maximal shape."""
    if len(parts) == 1 and parts[0].shape[1] == N_to and parts[0].shape[2] == d_to:
        return parts[0]
    return torch.cat([F.pad(x, (0, d_to - x.shape[2], 0, N_to - x.shape[1]))
                      for x in parts])


# ---------------------------------------------------------------------------
# param padding / unpadding between loop-backend and full-width layouts
# ---------------------------------------------------------------------------


# Below this many training rows the cohort is bound by launches, so MLP
# widths pad to the sub-batch max (zero padding is gradient-inert, DESIGN.md
# §10.4) and all same-depth trials share one sub-batch.  Above it the
# cohort is bound by arithmetic and width padding would inflate it up to
# 16x, so widths split into separate sub-batches instead (DESIGN.md §10.3).
WIDTH_PAD_MAX_ROWS = 2048


def _take(x, dim: int, fidx):
    return x.index_select(dim, torch.as_tensor(fidx, dtype=torch.int64, device=x.device))


def _unpad_linear(params, fidx, hp, c) -> dict:
    return {"w": _take(params["w"], 0, fidx)[:, :c], "b": params["b"][:c]}


def _unpad_mlp(params, fidx, hp, c) -> dict:
    width = int(hp["width"])
    layers, L = params["layers"], len(params["layers"])
    out = []
    for i, lyr in enumerate(layers):
        w, b = lyr["w"], lyr["b"]
        w = _take(w, 0, fidx) if i == 0 else w[:width]
        if i < L - 1:            # hidden outputs may be width-padded
            w, b = w[:, :width], b[:width]
        else:                    # output classes may be class-padded (§12.3)
            w, b = w[:, :c], b[:c]
        out.append({"w": w, "b": b})
    return {"layers": out}


def _unpad_gnb(params, fidx, hp, c) -> dict:
    return {"mean": _take(params["mean"][:c], 1, fidx), "var": _take(params["var"][:c], 1, fidx),
            "prior": params["prior"][:c]}


def _unpad_centroid(params, fidx, hp, c) -> dict:
    return {"cent": _take(params["cent"][:c], 1, fidx)}


_UNPAD: Dict[str, Callable] = {
    "logreg": _unpad_linear, "linear_svm": _unpad_linear, "mlp": _unpad_mlp,
    "gnb": _unpad_gnb, "centroid": _unpad_centroid,
}


def _unpad_trial(family: str, params_b, j: int, fidx, hp, c: int):
    single = _tree_map(lambda x: x[j], params_b)
    return _UNPAD[family](single, fidx, hp, c)


# ---------------------------------------------------------------------------
# cohort passes: train + eval / fit + eval of one family sub-batch
# ---------------------------------------------------------------------------


def _val_acc(fam, params, X, y):
    return (torch.argmax(fam.predict(params, X), dim=-1) == y).to(torch.float32).mean(-1)


def _train_eval_cohort(fam, params0, Xall, Xall_val, Yall, Yall_val,
                       vids, yids, hp, c, epochs, masks=None, steps=None):
    """Adam on the stacked params, then the validation accuracy of each
    trial.  The trajectory is ``models.adam_train``, the definition the loop
    backend runs, with per-trial ``lr``/``l2`` as ``(T,)`` tensors; each
    trial gathers its data variant from ``Xall`` and its job's labels from
    the stacked ``(J, N)`` label tensor ``Yall`` (J = 1 for a single job).

    ``masks`` is None on exact-shape passes; a heterogeneous-shape merge
    passes ``(Wtr (J, N), Wval (J, Nval), Cmask (J, c))`` and the trials
    train through the masked loss (DESIGN.md §12.3).  ``steps`` is None on
    uniform-rung passes; a cross-rung megabatch passes per-trial step
    budgets (DESIGN.md §13.1)."""
    X, y = Xall[vids], Yall[yids]                     # (T, N, d), (T, N)
    if masks is None:
        def loss_fn(p):
            return fam.loss(p, X, y, c, hp)
    else:
        w, cm = masks[0][yids], masks[2][yids]

        def loss_fn(p):
            return masked_loss(fam.name, p, X, y, w, cm, c, hp)
    params = adam_train(loss_fn, params0, hp["lr"], epochs, n_steps=steps)
    with torch.no_grad():
        if masks is None:
            return params, _val_acc(fam, params, Xall_val[vids], Yall_val[yids])
        return params, masked_accuracy(fam.name, params, Xall_val[vids], Yall_val[yids],
                                       masks[1][yids], masks[2][yids])


def _keyless_cohort(family, T, Xall, Xall_val, Yall, Yall_val, vids, yids,
                    hp, c, epochs, masks=None, steps=None):
    """Zero-init families: one init, broadcast to the sub-batch."""
    fam = FAMILIES[family]
    p0 = fam.init(None, Xall.shape[2], c, {}, Xall.device)
    params0 = _tree_map(lambda x: x.expand((T,) + x.shape).clone(), p0)
    return _train_eval_cohort(fam, params0, Xall, Xall_val, Yall, Yall_val,
                              vids, yids, hp, c, epochs, masks, steps)


def _mlp_init_padded(gin, i, k, width, ci, depth, wmax, d, c, dev):
    """Trial ``i``'s MLP init, drawn exactly as the loop backend draws it
    (its job's ``init_provider``, else ``_trial_generator(seed, trial_id,
    rung)`` at the actual ``(k, width, c_i)`` shapes), scattered into the
    full-feature, ``wmax``-wide, ``c``-class layout."""
    fam = FAMILIES["mlp"]
    p0 = None
    provider = gin["providers"][i]
    if provider is not None:
        p0 = provider(gin["specs"][i], gin["tids"][i], gin["rungs"][i], k, ci)
    if p0 is None:
        gen = _trial_generator(gin["seeds"][i], gin["tids"][i], gin["rungs"][i], dev)
        p0 = fam.init(gen, k, ci, {"width": width, "depth": depth}, dev)
    if k == d and width == wmax and ci == c:
        return p0
    layers, L = p0["layers"], len(p0["layers"])
    out = []
    for li, lyr in enumerate(layers):
        w, b = lyr["w"], lyr["b"]
        out_dim = c if li == L - 1 else wmax
        buf = w.new_zeros((d if li == 0 else wmax, out_dim))
        if li == 0:
            buf[:, : w.shape[1]].index_copy_(0, gin["fidxs"][i], w)
        else:
            buf[: w.shape[0], : w.shape[1]] = w
        bbuf = b.new_zeros((out_dim,))
        bbuf[: b.shape[0]] = b
        out.append({"w": buf, "b": bbuf})
    return {"layers": out}


def _mlp_cohort(desc, gin, d, Xall, Xall_val, Yall, Yall_val, c, epochs,
                masks=None, steps=None):
    """MLP sub-batch: loop-identical per-trial inits, stacked, trained and
    evaluated.  ``desc.shapes[i] = (k, width, c_i)`` per trial; ``c_i`` is
    the trial's own class count, so a heterogeneous merge draws exactly the
    solo shapes before class-padding.  Padded rows and columns are zero and
    stay zero under Adam (DESIGN.md §10.4, §12.3)."""
    plist = [_mlp_init_padded(gin, i, k, width, ci, desc.depth, desc.wmax, d, c, Xall.device)
             for i, (k, width, ci) in enumerate(desc.shapes)]
    return _train_eval_cohort(FAMILIES["mlp"], _tree_stack(plist), Xall, Xall_val, Yall,
                              Yall_val, gin["vids"], gin["yids"], gin["hp"], c, epochs,
                              masks, steps)


def _closed_cohort(family, Xall, Xall_val, Yall, Yall_val, vids, yids, hp, c,
                   masks=None):
    """Closed-form families: one batched fit and eval of the sub-batch."""
    fam = FAMILIES[family]
    X, y = Xall[vids], Yall[yids]
    with torch.no_grad():
        if masks is None:
            params = fam.fit_closed(None, X, y, c, hp)
            return params, _val_acc(fam, params, Xall_val[vids], Yall_val[yids])
        w, cm = masks[0][yids], masks[2][yids]
        params = masked_fit(family, X, y, w, cm, c, hp)
        return params, masked_accuracy(family, params, Xall_val[vids], Yall_val[yids],
                                       masks[1][yids], cm)


class _GroupDesc(NamedTuple):
    """Static descriptor of one family sub-batch."""
    kind: str            # "closed" | "keyless" | "mlp"
    family: str
    T: int
    depth: int = 0
    wmax: int = 0
    shapes: tuple = ()   # mlp: ((k, width, c_trial), ...) per trial


def _run_group(desc, gin, Xall, Xall_val, Yall, Yall_val, c, d,
               epochs, masks=None):
    """One sub-batch; shared by the whole-rung and per-group (budget) paths,
    so both run identical math.  ``gin["steps"]`` is present only when the
    sub-batch mixes step budgets (§13.1)."""
    steps = gin.get("steps")
    if desc.kind == "closed":
        return _closed_cohort(desc.family, Xall, Xall_val, Yall, Yall_val,
                              gin["vids"], gin["yids"], gin["hp"], c, masks)
    if desc.kind == "keyless":
        return _keyless_cohort(desc.family, desc.T, Xall, Xall_val, Yall,
                               Yall_val, gin["vids"], gin["yids"], gin["hp"],
                               c, epochs, masks, steps)
    return _mlp_cohort(desc, gin, d, Xall, Xall_val, Yall, Yall_val, c, epochs,
                       masks, steps)


def _eval_rung_fused(ginputs, Xparts, Xval_parts, Yall, Yall_val,
                     masks, *, descs, c: int, d: int, epochs: int):
    """The whole rung: every family sub-batch trains and evaluates, queued
    back to back with nothing that waits for the host (used when no
    wall-clock budget needs mid-rung cutoffs).  With merged cohorts the
    sub-batches span jobs.  ``Xparts``/``Xval_parts`` are per-job variant
    stacks, merged (and zero-padded to the ``Yall`` row count / ``d`` when
    job shapes differ); ``masks`` is None for exact shapes, or the (Wtr,
    Wval, Cmask) padding tensors of a heterogeneous merge (§12.3); ``epochs``
    is the largest step budget (§13.1)."""
    Xall = _concat_padded(Xparts, Yall.shape[1], d)
    Xall_val = _concat_padded(Xval_parts, Yall_val.shape[1], d)
    return tuple(
        _run_group(desc, gin, Xall, Xall_val, Yall, Yall_val, c, d, epochs, masks)
        for desc, gin in zip(descs, ginputs))


def _eval_group(gin, Xall, Xall_val, Yall, Yall_val, *, desc, c: int, d: int,
                epochs: int):
    """One sub-batch, waited for: the budget path, so the engine can check
    the wall clock between sub-batches."""
    params_b, vaccs = _run_group(desc, gin, Xall, Xall_val, Yall, Yall_val, c, d, epochs)
    if vaccs.is_cuda:
        torch.cuda.synchronize(vaccs.device)
    return params_b, vaccs


# ---------------------------------------------------------------------------
# rung drivers: single-job and cross-job merged
# ---------------------------------------------------------------------------


class _TaggedTrial(NamedTuple):
    """One trial of a (possibly merged) rung pass."""
    job: int         # job slot = yid into the stacked (J, N) label tensor
    pos: int         # position in its job's cohort
    spec: object     # PipelineSpec
    tid: int         # trial id (generator derivation)
    seed: int        # its job's AutoMLConfig.seed
    vid: int         # index into the merged variant stack
    c: int           # its job's class count (class-padding axis, §12.3)
    rung: int        # its own rung cursor (MLP init, §13)
    steps: int       # its own epoch budget at that rung (step mask, §13.1)
    provider: Optional[Callable] = None   # its job's ctx["init_provider"]


def _group_subbatches(trials: List[_TaggedTrial], pad_widths: bool, variants,
                      epochs_max: int, device):
    """Group tagged trials by ``(family,) + shape_hps`` into sub-batches.

    Returns ``[(trial_indices, desc, gin)]``: a static descriptor plus the
    sub-batch's inputs, each tensor already on ``device`` (the rung's passes
    then copy nothing from the host).  Trials from different jobs share a
    sub-batch whenever family and shape HPs match: the cross-job merge.

    ``epochs_max`` is the pass-wide step count.  Gradient sub-batches whose
    trials all train exactly ``epochs_max`` steps carry no ``steps``;
    mixed-budget sub-batches carry per-trial step masks (§13.1)."""
    def on_dev(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    groups: Dict[tuple, List[int]] = {}
    for t_i, t in enumerate(trials):
        hp = dict(t.spec.hp)
        fam = FAMILIES[t.spec.family]
        skip = ("width",) if pad_widths and t.spec.family == "mlp" else ()
        gkey = (t.spec.family,) + tuple(hp[k] for k in fam.shape_hps if k not in skip)
        groups.setdefault(gkey, []).append(t_i)

    subbatches: List[tuple] = []   # (trial_indices, desc, gin)
    for gkey, idxs in groups.items():
        family = gkey[0]
        fam = FAMILIES[family]
        gin = {
            "vids": on_dev([trials[i].vid for i in idxs], torch.int64),
            "yids": on_dev([trials[i].job for i in idxs], torch.int64),
            "hp": {k: on_dev([dict(trials[i].spec.hp)[k] for i in idxs], torch.float32)
                   for k in fam.hp_grid if k not in fam.shape_hps},
        }
        if fam.fit_closed is not None:
            # closed-form fits are epochs-independent: no step mask needed
            subbatches.append((idxs, _GroupDesc("closed", family, len(idxs)), gin))
            continue
        if any(trials[i].steps != epochs_max for i in idxs):
            gin["steps"] = on_dev([trials[i].steps for i in idxs], torch.int64)
        if fam.init_keyless:
            desc = _GroupDesc("keyless", family, len(idxs))
        else:   # mlp: the inits are drawn on the host's orders, per trial
            hps = [dict(trials[i].spec.hp) for i in idxs]
            fidxs = [variants[trials[i].vid]["fidx"] for i in idxs]
            shapes = tuple((len(f), int(h["width"]), trials[i].c)
                           for f, h, i in zip(fidxs, hps, idxs))
            gin.update(
                tids=tuple(trials[i].tid for i in idxs),
                seeds=tuple(trials[i].seed for i in idxs),
                rungs=tuple(trials[i].rung for i in idxs),
                specs=tuple(trials[i].spec for i in idxs),
                providers=tuple(trials[i].provider for i in idxs),
                fidxs=tuple(variants[trials[i].vid]["fidx_t"] for i in idxs))
            desc = _GroupDesc("mlp", family, len(idxs), depth=int(hps[0]["depth"]),
                              wmax=max(w for (_k, w, _c) in shapes), shapes=shapes)
        subbatches.append((idxs, desc, gin))
    return subbatches


def _unpack_results(evaluated, trials, variants, collect_params):
    """One host sync for the whole pass; per-trial result tuples.

    Returns ``{trial_index: (val_acc, params, fidx, stats)}``."""
    all_vaccs = torch.cat([v for (_i, v, _f, _pb) in evaluated]).cpu().numpy()
    results: Dict[int, tuple] = {}
    i = 0
    for idxs, _vaccs, family, params_b in evaluated:
        for j, t_i in enumerate(idxs):
            var = variants[trials[t_i].vid]
            if collect_params:
                # lazy: only the winner's params ever get sliced + unpadded
                # (the engine calls the thunk)
                params = functools.partial(
                    _unpad_trial, family, params_b, j, var["fidx"],
                    dict(trials[t_i].spec.hp), trials[t_i].c)
            else:
                params = None
            results[t_i] = (float(all_vaccs[i]), params, var["fidx"], var["stats"])
            i += 1
    return results


def _rung_inputs(cohort, tids, rung_i: int, epochs: int, ctx):
    """The host half of ``eval_rung_batched``: tag the trials, build the
    variants and the sub-batches, and put every input on the device.
    Returns ``(trials, variants, subbatches, common)``."""
    d, c = ctx["X_tr"].shape[1], ctx["n_classes"]
    # launch-bound small cohorts pad MLP widths into one sub-batch;
    # arithmetic-bound large ones split per width (see WIDTH_PAD_MAX_ROWS)
    pad_widths = ctx["X_tr"].shape[0] <= WIDTH_PAD_MAX_ROWS
    trials = [
        _TaggedTrial(0, pos, spec, int(tids[pos]), int(ctx["seed"]),
                     _variant(ctx, spec.preproc, spec.feature_frac), c,
                     rung_i, epochs, ctx["init_provider"])
        for pos, spec in enumerate(cohort)
    ]
    Xall_tr, Xall_val = _variant_stack(ctx)
    variants = {v["id"]: v for v in ctx["variant_cache"].values()}
    subbatches = _group_subbatches(trials, pad_widths, variants, epochs, ctx["device"])
    common = (Xall_tr, Xall_val, ctx["y_tr_t"][None], ctx["y_val_t"][None])
    return trials, variants, subbatches, common


def _run_subbatches(subbatches, common, c: int, d: int, epochs: int,
                    budget_active: bool = False, out_of_budget=None):
    """The device half of ``eval_rung_batched``: every sub-batch, queued
    with no host sync, or one at a time and waited for when a wall-clock
    budget is active.  Returns ``[(trial_indices, vaccs, family, params_b)]``
    with the accuracies still on the device."""
    evaluated: List[tuple] = []
    if budget_active:
        for idxs, desc, gin in subbatches:
            if out_of_budget() and evaluated:
                break
            params_b, vaccs = _eval_group(gin, *common, desc=desc, c=c, d=d, epochs=epochs)
            evaluated.append((idxs, vaccs, desc.family, params_b))
        return evaluated
    Xall_tr, Xall_val, Ytr, Yval = common
    outs = _eval_rung_fused(tuple(gin for (_i, _d, gin) in subbatches),
                            (Xall_tr,), (Xall_val,), Ytr, Yval, None,
                            descs=tuple(d_ for (_i, d_, _g) in subbatches),
                            c=c, d=d, epochs=epochs)
    return [(idxs, vaccs, desc.family, params_b)
            for (idxs, desc, _g), (params_b, vaccs) in zip(subbatches, outs)]


def _step_counts(subbatches, trials, epochs: int) -> dict:
    """What the host issues for ``subbatches``: ``adam_steps``, the Adam
    steps of the gradient sub-batches (``epochs`` each, step mask or not);
    ``trial_steps``, the steps their trials take each, the steps a trial by
    trial run would issue."""
    grad = [idxs for idxs, desc, _g in subbatches if desc.kind != "closed"]
    return {"adam_steps": epochs * len(grad),
            "trial_steps": sum(min(trials[i].steps, epochs) for idxs in grad for i in idxs)}


def eval_rung_batched(cohort, tids, rung_i: int, epochs: int, ctx,
                      out_of_budget, collect_params: bool = True) -> Tuple[list, list]:
    """Evaluate one successive-halving rung as per-family sub-batches.

    Returns ``(scored, positions)`` where ``scored[i]`` is the loop-backend
    tuple ``(spec, val_acc, params, feat_idx, pre_stats)`` and
    ``positions[i]`` is its index into ``cohort``.  ``collect_params=False``
    (non-final rungs) skips the per-trial unpadding thunks.  Accuracies stay
    on the device until one rung-level sync; when a wall-clock budget is
    active, each sub-batch is waited for before the budget check.

    Three spans (``obs/trace``) split the rung: ``automl.rung.prep``
    (variants, stacking, the inputs' copies), ``automl.rung.issue`` (the
    sub-batches queued; attrs from ``_step_counts``, and ``graph_steps``,
    the steps ``models.adam_train`` replayed from a CUDA graph) and
    ``automl.rung.wait`` (the one copy of the accuracies, which waits for
    the rung's device work)."""
    d, c = ctx["X_tr"].shape[1], ctx["n_classes"]
    with _trace.span(None, None, "automl.rung.prep"):
        trials, variants, subbatches, common = _rung_inputs(cohort, tids, rung_i, epochs, ctx)
    with _trace.span(None, None, "automl.rung.issue", graph_steps=0) as sp:
        evaluated = _run_subbatches(subbatches, common, c, d, epochs,
                                    ctx.get("budget_active", False), out_of_budget)
        sp["attrs"].update(_step_counts(subbatches[:len(evaluated)], trials, epochs))
    with _trace.span(None, None, "automl.rung.wait"):
        results = _unpack_results(evaluated, trials, variants, collect_params)
    # single job: trial index == cohort position
    eval_pos = sorted(results)
    scored = [(cohort[p],) + results[p] for p in eval_pos]
    return scored, eval_pos


def eval_rung_cohorts(cohorts: List[TrialCohort],
                      collect_params=None) -> List[Tuple[list, list]]:
    """Cross-job rung merge: one pass for many jobs' cohorts at the same
    ``(rung_i, epochs)``.  Returns per-job ``(scored, positions)`` pairs in
    input order.

    Two regimes (DESIGN.md §12.3): *exact* — all cohorts share ``(N_tr,
    N_val, d, n_classes)`` and merging changes only how the work is batched;
    *padded* — shapes differ, every job's variants are zero-padded to the
    group-maximal ``(N_max, d_max)``, labels to ``(J, N_max)``, and trials
    train through the row/class-masked losses, inert up to floating-point
    reduction order.  ``collect_params=None`` collects params iff any cohort
    asks for them.  No mid-rung time budget: budgeted jobs run solo via
    ``eval_rung_batched``."""
    rung_i, epochs = cohorts[0].rung_i, cohorts[0].epochs
    for tc in cohorts[1:]:
        if tc.rung_i != rung_i or tc.epochs != epochs:
            raise ValueError("eval_rung_cohorts: cohorts must share (rung_i, epochs)")
    return _eval_cohorts(cohorts, collect_params)


def eval_trial_megabatch(cohorts: List[TrialCohort],
                         collect_params=None) -> List[Tuple[list, list]]:
    """Continuous rung batching (DESIGN.md §13): one pass for cohorts at
    *different* rungs.  Same merge semantics as ``eval_rung_cohorts``, plus
    each trial's own rung cursor (its MLP init) and step budget from
    ``TrialCohort.trial_rungs`` / ``trial_steps``: the shared Adam loop runs
    ``max(steps)`` steps and shorter trials keep their params after their
    own budget (``models.adam_train``'s step mask).  Returns per-job
    ``(scored, positions)`` pairs in input order."""
    return _eval_cohorts(cohorts, collect_params)


def _eval_cohorts(cohorts: List[TrialCohort],
                  collect_params=None) -> List[Tuple[list, list]]:
    """Shared merge core for ``eval_rung_cohorts``/``eval_trial_megabatch``:
    tags trials (with their own rung cursor and step budget), pads shapes,
    groups sub-batches, and runs them as one rung pass."""
    device = cohorts[0].ctx["device"]
    if any(tc.ctx["device"] != device for tc in cohorts):
        raise ValueError("merged cohorts must share one device")
    if collect_params is None:
        collect_params = any(tc.collect for tc in cohorts)
    epochs = max(max(tc.trial_steps) for tc in cohorts)   # step count of the pass
    shapes = [tc.shape for tc in cohorts]
    hetero = len(set(shapes)) > 1
    N_max = max(s[0] for s in shapes)
    Nval_max = max(s[1] for s in shapes)
    d = max(s[2] for s in shapes)
    c = max(s[3] for s in shapes)
    pad_widths = N_max <= WIDTH_PAD_MAX_ROWS

    # register every trial's variant in its own job's cache first (caches
    # persist across rungs), then offset local variant ids into one merged
    # stack: merged vid = job's offset + local vid
    local = []
    for slot, tc in enumerate(cohorts):
        for pos, spec in enumerate(tc.specs):
            lvid = _variant(tc.ctx, spec.preproc, spec.feature_frac)
            local.append((slot, pos, spec, int(tc.tids[pos]), int(tc.ctx["seed"]), lvid,
                          int(tc.trial_rungs[pos]), int(tc.trial_steps[pos])))
    offsets = np.concatenate([[0], np.cumsum(
        [len(tc.ctx["variant_cache"]) for tc in cohorts])])
    trials = [_TaggedTrial(slot, pos, spec, tid, seed, int(offsets[slot]) + lvid,
                           int(cohorts[slot].ctx["n_classes"]), rung, nsteps,
                           cohorts[slot].ctx["init_provider"])
              for (slot, pos, spec, tid, seed, lvid, rung, nsteps) in local]

    stacks = [_variant_stack(tc.ctx) for tc in cohorts]
    if hetero:
        # the per-job stacks are zero-padded to the group-maximal shape in
        # the pass (``_concat_padded``); the masks make the padding inert
        def on_dev(rows, dtype):
            return torch.as_tensor(np.stack(rows), dtype=dtype, device=device)
        Yall_tr = on_dev([np.pad(tc.ctx["y_tr"], (0, N_max - tc.ctx["y_tr"].shape[0]))
                          for tc in cohorts], torch.int64)
        Yall_val = on_dev([np.pad(tc.ctx["y_val"], (0, Nval_max - tc.ctx["y_val"].shape[0]))
                           for tc in cohorts], torch.int64)
        masks = (
            on_dev([np.arange(N_max) < s[0] for s in shapes], torch.float32),
            on_dev([np.arange(Nval_max) < s[1] for s in shapes], torch.float32),
            on_dev([np.where(np.arange(c) < s[3], 0.0, CLASS_MASK_NEG) for s in shapes],
                   torch.float32),
        )
    else:
        Yall_tr = torch.stack([tc.ctx["y_tr_t"] for tc in cohorts])
        Yall_val = torch.stack([tc.ctx["y_val_t"] for tc in cohorts])
        masks = None
    variants = {}
    for slot, tc in enumerate(cohorts):
        for v in tc.ctx["variant_cache"].values():
            variants[int(offsets[slot]) + v["id"]] = v

    subbatches = _group_subbatches(trials, pad_widths, variants, epochs, device)
    outs = _eval_rung_fused(tuple(gin for (_i, _d, gin) in subbatches),
                            tuple(s[0] for s in stacks), tuple(s[1] for s in stacks),
                            Yall_tr, Yall_val, masks,
                            descs=tuple(d_ for (_i, d_, _g) in subbatches),
                            c=c, d=d, epochs=epochs)
    evaluated = [(idxs, vaccs, desc.family, params_b)
                 for (idxs, desc, _g), (params_b, vaccs) in zip(subbatches, outs)]
    results = _unpack_results(evaluated, trials, variants, collect_params)

    per_job: List[Tuple[list, list]] = []
    for slot, tc in enumerate(cohorts):
        idxs = [i for i in sorted(results) if trials[i].job == slot]
        scored = [(tc.specs[trials[i].pos],) + results[i] for i in idxs]
        per_job.append((scored, [trials[i].pos for i in idxs]))
    return per_job
