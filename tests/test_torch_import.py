"""The PyTorch port stands alone: no JAX, no reference package (nor its
``benchmarks/``), no silent CPU.

Tolerances: none (import and dispatch checks only).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_cases import run_every_op

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro',\n"
        "                                                          'benchmarks'))\n"
        "assert len(names) >= 20, names\n"
        "for m in ('models.lm', 'models.ssm', 'models.moe', 'models.encdec',\n"
        "          'configs.zamba2_2p7b', 'configs.qwen2_moe_a2p7b', 'configs.kimi_k2_1t',\n"
        "          'configs.phi3_vision_4p2b', 'configs.whisper_base', 'launch.serve',\n"
        "          'automl.batched', 'core.baselines', 'core.strategies',\n"
        "          'kernels.flash_attention.kernel', 'kernels.ssd_scan.kernel',\n"
        "          'obs.metrics', 'obs.torchprof', 'launch.flops', 'meta.features',\n"
        "          'meta.store', 'meta.portfolio', 'service.fingerprint', 'service.cache',\n"
        "          'service.scheduler', 'service.server', 'service.wire', 'service.worker',\n"
        "          'service.transport', 'distributed.checkpoint', 'distributed.fault',\n"
        "          'launch.serve_tabular', 'train.optimizer', 'train.train_step',\n"
        "          'data.pipeline', 'launch.train', 'launch.mesh', 'distributed.sharding',\n"
        "          'distributed.compression', 'models.pmm', 'configs.base',\n"
        "          'launch.costs', 'launch.dryrun', 'launch.compare', 'launch.quickstart',\n"
        "          'launch.automl_tabular', 'launch.check_warm_start', 'launch.check_metrics',\n"
        "          'launch.check_recompile_budget', 'launch.check_chaos_parity',\n"
        "          'launch.serve_lm', 'launch.train_lm'):\n"
        "    assert 'repro_torch.' + m in names, m\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing the port started a process group'\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small_data():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 5, (64, 4)).astype(np.float32)
    y = rng.integers(0, 2, 64)
    return X, y


def test_entry_points_raise_without_a_card(no_cuda):
    from repro_torch import configs
    from repro_torch.automl.engine import AutoMLConfig, automl_fit
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core.baselines import km_dst, mc_dst
    from repro_torch.core.gen_dst import gen_dst, gen_dst_batch
    from repro_torch.core.strategies import asp_proxy_dst
    from repro_torch.launch import serve
    from repro_torch.core.measures import factorize
    from repro_torch.core.plan import execute, plan
    from repro_torch.service import (
        DistributedScheduler, ProcessWorkerPool, Scheduler, SimWorkerPool, SubStratServer,
    )
    from repro_torch.launch import serve_tabular
    from repro_torch.launch import train
    from repro_torch.data.pipeline import SyntheticCorpus, corpus_to_coded, select_corpus_subset
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import init_train_state
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    corpus = SyntheticCorpus(16, 9, 64)
    X, y = _small_data()
    coded = factorize(X, y, device="cpu")
    calls = [
        lambda: factorize(X, y),
        lambda: gen_dst(None, coded),
        lambda: gen_dst_batch([None], [coded]),
        lambda: mc_dst(None, coded),
        lambda: km_dst(None, coded),
        lambda: asp_proxy_dst(None, coded),
        lambda: execute(plan("mab"), X, y),
        lambda: automl_fit(X, y, config=AutoMLConfig(n_trials=2, rungs=(2,))),
        lambda: execute(plan("gen_dst"), X, y),
        lambda: factorize(X, y, device="cuda"),
        lambda: serve.main(["--arch", "mamba2-130m"]),
        lambda: serve.main(["--arch", "qwen2-moe-a2.7b"]),
        lambda: lm_params_from_numpy({}, configs.get_arch("mamba2-130m").smoke),
        lambda: Scheduler(),
        lambda: SubStratServer(),
        lambda: ProcessWorkerPool(1),
        lambda: DistributedScheduler(SimWorkerPool(1)),
        lambda: serve_tabular.main(["--jobs", "1", "--scale", "0.01"]),
        lambda: train.main(["--arch", "mamba2-130m", "--steps", "1"]),
        lambda: select_corpus_subset(corpus, 4),
        lambda: corpus_to_coded(corpus),
        lambda: init_train_state(None, configs.get_arch("mamba2-130m").smoke,
                                 adamw(lambda s: 1e-3)),
        lambda: make_mesh((1, 1), ("data", "model")),
        lambda: make_production_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    from repro_torch.core.gen_dst import GenDSTConfig, gen_dst
    from repro_torch.core.measures import factorize
    X, y = _small_data()
    coded = factorize(X, y, device="cpu")
    res = gen_dst(None, coded, 8, 2, GenDSTConfig(psi=2, phi=4), device="cpu")
    assert res.row_idx.device.type == "cpu"
    assert res.history.shape == (2,)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper launches or raises: it never runs the plain version."""
    from repro_torch.kernels.entropy.kernel import masked_histogram_cuda
    from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
    codes = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        masked_histogram_cuda(codes, torch.ones(4), 8)
    counts = torch.zeros((3, 2, 8))
    z = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_delta_fitness_cuda(counts, z, z, torch.zeros(3), z.bool(), torch.zeros(1))


def test_ops_dispatch_on_device_and_count_no_cpu_launch():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    run_every_op("cpu")
    assert kernels.launch_counts() == {"masked_histogram": 0, "fused_delta_fitness": 0,
                                       "flash_attention": 0, "ssd_scan": 0}
