"""Training launcher of the port (after the JAX package's ``launch/train.py``):
the arch registry, the LM data pipeline with optional SubStrat corpus-subset
selection, the train step and checkpoints written asynchronously, resumed
from the latest on restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --preset full \\
        --batch 4 --seq 512 --accum 2 --substrat-subset 256

``--preset cpu-small`` (the default) trains the arch's smoke config,
``--preset full`` its published config.  The multimodal archs (encdec, vlm)
are refused, as the reference's launcher refuses them.  Weights are drawn
from ``--seed`` on the device in ``param_dtype``; the subset search draws
from its own generator seeded with ``--seed``; the corpus and the loader's
order are seeded with 0, as in the reference.  ``main`` returns the final
``TrainState``.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..configs import ARCHS, get_arch
from ..data.pipeline import LoaderState, ShardedLoader, SyntheticCorpus, select_corpus_subset
from ..device import make_generator, resolve_device
from ..distributed.checkpoint import CheckpointManager, restore_latest
from ..train.optimizer import make_optimizer, warmup_cosine
from ..train.train_step import TrainState, init_train_state, make_train_step

__all__ = ["main"]


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--preset", choices=["cpu-small", "full"], default="cpu-small")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--corpus-seqs", type=int, default=2048)
    ap.add_argument("--substrat-subset", type=int, default=0,
                    help="if >0, train on an entropy-preserving corpus subset "
                         "of this many sequences (SubStrat step 1)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.preset == "cpu-small" else arch.config
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit(f"{args.arch}: use the model entry points for multimodal "
                         "input plumbing; train.py covers token-LM archs")
    dev = resolve_device(args.device)

    corpus = SyntheticCorpus(args.corpus_seqs, args.seq + 1, cfg.vocab_size, seed=0)
    subset = None
    if args.substrat_subset:
        t0 = time.perf_counter()
        subset = select_corpus_subset(corpus, args.substrat_subset,
                                      generator=make_generator(args.seed, dev),
                                      sample_rows=min(args.corpus_seqs, 4096), device=dev)
        print(f"[substrat] selected {len(subset)} / {len(corpus)} sequences "
              f"in {time.perf_counter() - t0:.1f}s")
    loader = ShardedLoader(corpus, args.batch, seed=0, subset=subset)

    opt = make_optimizer(
        arch.optimizer,
        warmup_cosine(args.lr or arch.peak_lr, warmup=20, total=args.steps),
    )
    state = init_train_state(make_generator(args.seed, dev), cfg, opt)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum)

    ckpt = CheckpointManager(Path(args.ckpt_dir) / args.arch)
    restored = restore_latest(ckpt.dir, state)
    start = 0
    if restored is not None:
        del state
        state, start = restored
        start += 1
        loader.restore(LoaderState(start))
        print(f"[ckpt] resumed from step {start - 1}")

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in loader.next().items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = (time.perf_counter() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} {dt * 1e3:.0f} ms/step",
                  flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step, state)
    ckpt.wait()
    print(f"done: {args.steps - start} steps in {time.perf_counter() - t0:.1f}s")
    return state


if __name__ == "__main__":
    main()
