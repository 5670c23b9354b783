"""The yardstick's arithmetic: the card's peaks, the kernels' least bytes,
and the useful operations of an AutoML trial.

The byte counts of B1 (``masked_histogram``) and B2
(``fused_delta_fitness``) are frozen copies of the bounds ``chip_smoke.py``
states for them (its B1/B2 phases, with ``PERF.md``'s kernel table): each
input byte read once, each output byte written once.  The FLOP counts of the
AutoML families follow the definitions in ``src/repro_torch/automl/models.py``
(products as 2 m n k; the closed-form families' elementwise terms counted
per element); ``src/repro_torch/launch/flops.py`` counts the MLP alone.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM, the data sheet's dense rates (at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores; the port keeps TF32 off


def b1_bytes(P: int, n: int, M: int, B: int) -> int:
    """One gathered masked histogram of P candidates of n rows over M columns
    into B bins: the gathered codes and the row index read once, the counts
    written once."""
    return n * P * M * 4 + P * n * 4 + P * M * B * 4


def b2_bytes(P: int, M: int, B: int, n_applied: int = 0) -> int:
    """One fused delta-and-fitness step: the counts read once; the codes,
    delta, mask and F(D) read once; the fitness written once; two bins
    stored per column of each candidate whose delta is applied."""
    return (P * M * B * 4 + 2 * P * M * 4 + P * 4 + P * M + 4 + P * 4
            + 2 * n_applied * M * 4)


def gen_dst_bytes(psi: int, phi: int, islands: int, n: int, M: int, B: int,
                  cross_every: int, incremental: bool) -> int:
    """Least bytes of one Gen-DST search's fitness work: the initial scoring,
    then per generation a histogram rebuild (after a crossover, or without
    the incremental delta) or a one-row delta applied to every candidate,
    each reduced to fitness."""
    P = phi * islands
    total = b1_bytes(P, n, M, B) + b2_bytes(P, M, B)
    for g in range(psi):
        if g % cross_every == 0 or not incremental:
            total += b1_bytes(P, n, M, B) + b2_bytes(P, M, B)
        else:
            total += b2_bytes(P, M, B, n_applied=P)
    return total


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def trial_flops(family: str, hp: dict, n_tr: int, n_val: int, k: int, c: int,
                steps: int) -> float:
    """Useful operations of one trial: its training on ``n_tr`` rows of ``k``
    features and ``c`` classes (``steps`` full-batch Adam steps, or the
    closed-form fit) and its scoring of ``n_val`` rows."""
    if family in ("logreg", "linear_svm"):
        fwd = 2.0 * k * c
        # forward and the weight gradient per row and step; the scoring pass
        return steps * n_tr * 2 * fwd + n_val * fwd
    if family == "mlp":
        width, depth = int(hp["width"]), int(hp["depth"])
        dims = [k] + [width] * depth + [c]
        prods = [2.0 * a * b for a, b in zip(dims[:-1], dims[1:])]
        fwd = sum(prods)
        # forward, every weight gradient, every input gradient but the first
        train = fwd + fwd + sum(prods[1:])
        return steps * n_tr * train + n_val * fwd
    if family == "gnb":
        # class sums of x and x^2, then 5 operations per (row, class, feature)
        return 2 * 2.0 * n_tr * c * k + 5.0 * n_val * c * k
    if family == "centroid":
        return 2.0 * n_tr * c * k + 3.0 * n_val * c * k
    raise ValueError(family)


def pass_flops(trials, rungs, keep_frac: float, n_rows: int, d: int, c: int,
               val_frac: float) -> float:
    """Useful operations of one AutoML pass from its trial log: each logged
    trial at its rung's steps, on the engine's split of ``n_rows``."""
    n_val = max(1, int(val_frac * n_rows))
    n_tr = n_rows - n_val
    # the log holds each rung's cohort in turn; its sizes follow from rung 0's
    sizes, n = [], None
    for n0 in range(1, len(trials) + 1):
        sizes, n = [], n0
        for _ in rungs:
            sizes.append(n)
            n = max(1, int(math.ceil(n * keep_frac)))
        if sum(sizes) == len(trials):
            break
    total, i = 0.0, 0
    for r, size in enumerate(sizes):
        for spec, _ in trials[i:i + size]:
            k = max(1, int(round(spec.feature_frac * d)))
            total += trial_flops(spec.family, dict(spec.hp), n_tr, n_val, min(k, d), c,
                                 int(rungs[r]))
        i += size
    return total
