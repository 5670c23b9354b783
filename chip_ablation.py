#!/usr/bin/env python3
"""The masked-histogram (B1) and fused Gen-DST (B2) kernels of this tree
against those of an earlier tree, on one CUDA card, at the inputs SubStrat's
main path gives them; and where the host time of their calls goes.

    python3 chip_ablation.py --parent DIR
    python3 chip_ablation.py --host DIR

With ``--parent DIR`` (an unpacked earlier tree of this repository) the two
kernels of that tree are built from its ``src/repro_torch/csrc`` (one nvcc
each, started together) and timed beside this tree's on the same inputs,
each first held to the plain version (B1 exact; B2 counts bit-equal,
fitness within 1e-6); device us per launch from ``torch.profiler``, in the
order this, parent, parent, this.  Inputs: paper dataset D1 at full scale,
factorized, 100 candidates of 322 rows and all 23 columns, B = 256, as
``chip_smoke.py`` builds them.  B1 through the gathered entry, or, for a
parent whose launcher takes no row index, on the gathered fold (322, 2300)
that its caller had to build, beside the device time of that whole
composition (cast, gather, transpose copy, fill, histogram).  B2 with a
zero delta, as every main-path generation calls it, and with a delta on
every candidate, at D1 and at 100 columns (a random table of 20,000 rows,
more columns than a CTA's 32 warps).  Then the host us per call of the
parts of this tree's B1 and B2 wrappers.

With ``--host DIR`` it only times the host side of the B1 and B2 calls of
the tree at DIR (this one or an earlier one): each wrapper, and each op as
Gen-DST calls it, host us per call at D1's inputs.

Needs a CUDA card; imports nothing of JAX.  Prints one line per reading.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIT_TOL = 1e-6


def build_parent(_build, parent: Path) -> tuple[dict, bool]:
    """({source stem: loaded launcher} of the parent tree's B1 and B2, one
    nvcc each, started together; whether its B1 launcher takes a row index)."""
    csrc = parent / "src" / "repro_torch" / "csrc"
    out_dir = _build.BUILD_DIR.parent / "ablation_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("masked_histogram", "fused_delta_fitness"):
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, str(csrc / f"{stem}.cu"), "-o", str(lib)]
        procs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    libs, gathers = {}, True
    for stem, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log)
            raise SystemExit(f"chip_ablation: nvcc failed on the parent's {stem}.cu")
        fn = getattr(ctypes.CDLL(str(lib)), f"launch_{stem}")
        fn.restype = ctypes.c_int
        source = (csrc / f"{stem}.cu").read_text()
        if stem == "masked_histogram" and "const void* rows" not in source:
            fn.argtypes = [P_, P_, P_, I_, I_, I_, I_, P_]    # no row index: an older launcher
            gathers = False
        elif stem == "fused_delta_fitness" and "f_ref_step" not in source:
            # one f_ref for every candidate: an older launcher, called with
            # this tree's arguments less the f_ref step (which must be 0)
            fn.argtypes = [P_] * 7 + [I_] * 3 + [P_]
            fn = (lambda raw: lambda *a: raw(*a[:10], a[11]))(fn)
        else:
            fn.argtypes = _build._SIGNATURES[stem]
        libs[stem] = fn
    return libs, gathers


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ablation: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser()
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent", type=Path, help="an unpacked earlier tree to time against")
    group.add_argument("--host", type=Path, help="only time the host side of that tree's calls")
    args = ap.parse_args()
    if args.host is not None:
        host_mode(torch, args.host.resolve())
        return
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core.measures import factorize, full_column_entropy
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.device import make_generator, resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.entropy.kernel import population_histogram_rows_cuda
    from repro_torch.kernels.entropy.ref import masked_histogram_ref
    from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
    from repro_torch.kernels.gen_dst.ref import fused_delta_fitness_ref

    print(f"card: {cs.smi_line()}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = _build.library()
    parent, parent_gathers = build_parent(_build, args.parent.resolve())
    print(f"built this tree's kernels and the parent's in {time.perf_counter() - t0:.1f} s")

    # the main path's inputs, as chip_smoke.py builds them
    X, y = make_dataset(PAPER_DATASETS["D1"], scale=1.0)
    X_tr, y_tr, _, _ = train_test_split(X, y)
    coded = factorize(X_tr, y_tr, device=dev)
    codes = coded.codes
    N, M = codes.shape
    B = coded.max_bins
    P, n, m = 100, round(N ** 0.5), round(0.25 * M)
    rows = torch.randint(0, N, (P, n), generator=make_generator(1234, dev), device=dev,
                         dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"D1: N {N}, M {M}, B {B}; P {P}, n {n}")

    def check(err, what):
        if err != 0:
            raise SystemExit(f"chip_ablation: {what} returned cudaError_t {err}")

    def plain_hist(codes_, rows_):
        """population_histogram(codes[rows]) with the plain histogram."""
        f = codes_[rows_.long()].permute(1, 0, 2).reshape(rows_.shape[1], -1)
        return masked_histogram_ref(f, torch.ones(f.shape[0], device=dev), B).reshape(
            rows_.shape[0], codes_.shape[1], B)

    def held(run, out, want, what):
        out.fill_(-1.0)
        run()
        torch.cuda.synchronize()
        if not torch.equal(out.reshape(want.shape), want):
            raise SystemExit(f"chip_ablation: {what} not exact")

    # --- B1 ---------------------------------------------------------------------
    h_plain = plain_hist(codes, rows)
    out = torch.empty((P, M, B), device=dev)
    flat = codes[rows.long()].permute(1, 0, 2).reshape(n, P * M).contiguous()
    ones = torch.ones(n, device=dev)
    pb1 = parent["masked_histogram"]

    def this_b1():
        check(lib.launch_masked_histogram(codes.data_ptr(), None, rows.data_ptr(),
                                          out.data_ptr(), N, M, B, P, n, 8, stream), "b1")

    if parent_gathers:
        def parent_b1():
            check(pb1(codes.data_ptr(), None, rows.data_ptr(), out.data_ptr(), N, M, B, P, n, 8,
                      stream), "parent b1")
        parent_label = "parent, gathered entry"
    else:
        def parent_b1():
            check(pb1(flat.data_ptr(), ones.data_ptr(), out.data_ptr(), n, P * M, B, 8, stream),
                  "parent b1")
        parent_label = f"parent, on the fold ({n}, {P * M}), weights of 1"
    print(f"B1, D1 (P, n, M, B) = ({P}, {n}, {M}, {B}): device us per launch")
    for label, run in (("this, gathered entry", this_b1), (parent_label, parent_b1),
                       (parent_label, parent_b1), ("this, gathered entry", this_b1)):
        held(run, out, h_plain, label)
        print(f"  {label}: {device_us(torch, run, 'masked_histogram_kernel'):.3f}")
    if not parent_gathers:
        def composition():
            sub = codes[rows.long()]
            f = sub.permute(1, 0, 2).reshape(n, P * M).contiguous()
            w = torch.ones(n, device=dev)
            check(pb1(f.data_ptr(), w.data_ptr(), out.data_ptr(), n, P * M, B, 8, stream),
                  "parent b1")
        comp = device_total_us(torch, composition, calls=50)
        print(f"  parent composition (cast, gather, copy, fill, histogram): {comp[0]:.3f} us "
              f"of device time in {comp[1]:.1f} kernels per call")

    # --- B2 ---------------------------------------------------------------------
    f_ref = full_column_entropy(codes, B).mean().reshape(1)
    fit = torch.empty(P, device=dev)
    zero = torch.zeros(P, device=dev)
    every = torch.ones(P, device=dev)
    gen = make_generator(99, dev)
    Mw = 100
    card = torch.randint(2, B + 1, (Mw,), generator=gen, device=dev)
    codes_w = (torch.rand((20000, Mw), generator=gen, device=dev) * card).to(torch.int32)
    rows_w = torch.randint(0, 20000, (P, n), generator=gen, device=dev, dtype=torch.int32)
    cm = torch.zeros((P, M), dtype=torch.bool, device=dev)
    cm[:, :m] = True
    shapes = {
        M: (h_plain, codes[rows[:, 0].long()].contiguous(),
            codes[rows[:, 1].long()].contiguous(), cm),
        Mw: (plain_hist(codes_w, rows_w), codes_w[rows_w[:, 0].long()].contiguous(),
             codes_w[rows_w[:, 1].long()].contiguous(),
             torch.rand((P, Mw), generator=gen, device=dev) < 0.25),
    }
    for Mx, (counts0, old, new, cmx) in shapes.items():
        print(f"B2, (P, M, B) = ({P}, {Mx}, {B}): device us per launch, zero delta and a "
              "delta on every candidate (new = old, so repeated calls leave the counts)")
        for label, fn in (("this", lib.launch_fused_delta_fitness),
                          ("parent", parent["fused_delta_fitness"]),
                          ("parent", parent["fused_delta_fitness"]),
                          ("this", lib.launch_fused_delta_fitness)):
            def run(fn=fn, counts=None, applied=zero, new_=new):
                check(fn(counts.data_ptr(), old.data_ptr(), new_.data_ptr(), applied.data_ptr(),
                         cmx.data_ptr(), f_ref.data_ptr(), fit.data_ptr(), P, Mx, B, 0, stream),
                      f"{label} b2")
            mut = (torch.arange(P, device=dev) % 2).float()
            ck = counts0.clone()
            run(counts=ck, applied=mut)
            cr, fr = fused_delta_fitness_ref(counts0.clone(), old, new, mut, cmx, f_ref)
            torch.cuda.synchronize()
            err = (fit - fr).abs().max().item()
            if not (torch.equal(ck, cr) and err <= FIT_TOL):
                raise SystemExit(f"chip_ablation: {label} b2 wrong at M={Mx} (fitness {err})")
            counts = counts0.clone()
            us_zero = device_us(torch, lambda: run(counts=counts), "fused_delta_fitness_kernel")
            us_delta = device_us(torch, lambda: run(counts=counts, applied=every, new_=old),
                                 "fused_delta_fitness_kernel")
            if not torch.equal(counts, counts0):
                raise SystemExit(f"chip_ablation: {label} b2: a delta with new = old moved counts")
            print(f"  {label:6s}: zero delta {us_zero:.3f}, every candidate's delta "
                  f"{us_delta:.3f}  (fitness err {err:.2e})")

    # where a wrapper's host time goes: the whole call and its parts
    counts = h_plain.clone()
    old, new = shapes[M][1], shapes[M][2]
    parts = {
        "B1 wrapper (population_histogram_rows_cuda)":
            lambda: population_histogram_rows_cuda(codes, rows, B),
        "B2 wrapper (fused_delta_fitness_cuda)":
            lambda: fused_delta_fitness_cuda(counts, old, new, zero, cm, f_ref),
        "torch.empty((P, M, B), device=...)": lambda: torch.empty((P, M, B), device=dev),
        "codes.new_empty((P, M, B), dtype=float32)":
            lambda: codes.new_empty((P, M, B), dtype=torch.float32),
        "_build.stream(device)": lambda: _build.stream(0),
        "B1 ctypes launch alone": this_b1,
        "B2 ctypes launch alone": lambda: lib.launch_fused_delta_fitness(
            counts.data_ptr(), old.data_ptr(), new.data_ptr(), zero.data_ptr(), cm.data_ptr(),
            f_ref.data_ptr(), fit.data_ptr(), P, M, B, 0, stream),
        "six get_device() calls": lambda: (counts.get_device(), old.get_device(),
                                           new.get_device(), zero.get_device(),
                                           cm.get_device(), f_ref.get_device()),
        "six is_contiguous() calls": lambda: (counts.is_contiguous(), old.is_contiguous(),
                                              new.is_contiguous(), zero.is_contiguous(),
                                              cm.is_contiguous(), f_ref.is_contiguous()),
    }
    print(f"host us per call (median of 5 x 100), {cs.smi_line()}")
    for label, fn in parts.items():
        print(f"  {label}: {cs.host_us(torch, fn):.2f}")
    print(f"card: {cs.smi_line()}")


def host_mode(torch, tree: Path) -> None:
    """Host us per call of the B1 and B2 calls of the tree at ``tree`` (this
    one or an earlier one), at D1's inputs: each wrapper, and each op as
    Gen-DST calls it per generation (B1: the rows' histograms; B2: the
    fused step with a zero delta)."""
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.measures import factorize, full_column_entropy
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    from repro_torch.device import make_generator, resolve_device
    from repro_torch.kernels.entropy import ops as hops
    from repro_torch.kernels.entropy.kernel import masked_histogram_cuda
    from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
    from repro_torch.kernels.gen_dst.ops import fused_delta_fitness

    dev = resolve_device("cuda")
    X, y = make_dataset(PAPER_DATASETS["D1"], scale=1.0)
    X_tr, y_tr, _, _ = train_test_split(X, y)
    coded = factorize(X_tr, y_tr, device=dev)
    codes, B = coded.codes, coded.max_bins
    N, M = codes.shape
    P, n, m = 100, round(N ** 0.5), round(0.25 * M)
    rows = torch.randint(0, N, (1, P, n), generator=make_generator(1234, dev), device=dev,
                         dtype=torch.int32)
    flat = codes[rows[0].long()].permute(1, 0, 2).reshape(n, P * M).contiguous()
    ones = torch.ones(n, device=dev)
    if hasattr(hops, "population_histogram_rows"):
        step = "population_histogram_rows(codes, rows, B)"

        def b1_step():
            return hops.population_histogram_rows(codes, rows.reshape(-1, n), B)
    else:
        step = "population_histogram(codes[rows.long()], B)"

        def b1_step():
            return hops.population_histogram(codes[rows.reshape(-1, n).long()], B)
    counts = b1_step().reshape(1, P, M, B)
    old = codes[rows[0, :, 0].long()].reshape(1, P, M)
    new = codes[rows[0, :, 1].long()].reshape(1, P, M)
    cm = torch.zeros((1, P, M), dtype=torch.bool, device=dev)
    cm[..., :m] = True
    zero = torch.zeros((1, P), device=dev)
    f_ref = full_column_entropy(codes, B).mean()
    flat_b2 = (counts[0], old[0], new[0], zero[0], cm[0], f_ref.reshape(1))
    parts = {
        "B1 wrapper, unindexed, on the fold": lambda: masked_histogram_cuda(flat, ones, B),
        f"B1 as Gen-DST calls it, {step}": b1_step,
        "B2 wrapper": lambda: fused_delta_fitness_cuda(*flat_b2),
        "B2 as Gen-DST calls it, fused_delta_fitness(...) on (1, P, ...) inputs":
            lambda: fused_delta_fitness(counts, old, new, zero, cm, f_ref),
    }
    print(f"host us per call (median of 5 x 100) of the tree at {tree.name}, {cs.smi_line()}")
    for label, fn in parts.items():
        print(f"  {label}: {cs.host_us(torch, fn):.2f}")


def device_us(torch, fn, kernel: str) -> float:
    """Device us per launch of ``kernel`` over 100 calls of ``fn``, from
    torch.profiler; a profile that saw no launch of it (one such read has
    been seen on the chip machine) is taken again, up to three times, and
    then reported as nan (not measured)."""
    import chip_smoke as cs
    for _ in range(3):
        ms = cs.kernel_device_ms(torch, fn, kernel, calls=100)
        if ms is not None:
            return ms * 1e3
    return float("nan")


def device_total_us(torch, fn, calls: int):
    """(device us per call summed over every kernel and copy, kernels per call)
    over ``calls`` calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    return (sum(cs.dev_us(e) for e in events) / calls,
            sum(e.count for e in events) / calls)


if __name__ == "__main__":
    main()
