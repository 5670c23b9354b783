"""The port's ``obs/metrics.py``, ``obs/torchprof.py`` and ``launch/flops.py``
held to the JAX package's ``obs/metrics.py``, ``obs/jaxprof.py`` and
``launch/flops.py``.

Tolerances: none.  The exposition text and ``state_dict`` must be equal for
the same sequence of operations, and every FLOP count equal as a float (the
port runs the same arithmetic in the same order).
"""
import json

import numpy as np
import pytest

from _torch_port import port_config
from repro import configs as JC
from repro.launch import flops as JF
from repro.models.config import SHAPES as J_SHAPES
from repro.obs import jaxprof
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.service.scheduler import CohortMeta as JMeta
from repro_torch import configs as TC
from repro_torch import kernels
from repro_torch.launch import flops as TF
from repro_torch.models.config import SHAPES as T_SHAPES
from repro_torch.obs import torchprof
from repro_torch.obs.metrics import MetricsRegistry as TRegistry
from repro_torch.service.scheduler import CohortMeta as TMeta


def _drive(reg):
    """One sequence of operations on a registry: every family kind, labels
    that need escaping, integral and fractional values."""
    c = reg.counter("reqs_total", "requests\nby mode", labels=("mode",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", labels=("mode",), buckets=(0.1, 1.0, 5.0))
    e = reg.histogram("empty_seconds", "never observed")
    reg.counter("bare_total", "label-less, never touched")
    c.inc(mode="solo")
    c.inc(2.5, mode='mer"ged\\')
    g.set(3.5)
    g.set(-1.0)
    for v in (0.05, 5.0, 0.7, 12.0):
        h.observe(v, mode="solo")
    h.observe(0.2, mode="merged")
    assert reg.counter("reqs_total", "requests\nby mode", labels=("mode",)) is c
    with pytest.raises(ValueError):
        c.inc(wrong_label=1)
    with pytest.raises(ValueError):
        reg.gauge("reqs_total", "type clash")
    with pytest.raises(ValueError):
        c.inc(-1, mode="solo")
    return c, g, h, e


def test_metrics_exposition_and_state_equal_the_reference():
    jreg, treg = JRegistry(), TRegistry()
    _drive(jreg)
    _drive(treg)
    assert treg.render() == jreg.render()
    assert treg.to_dict() == jreg.to_dict()
    assert treg.state_dict() == jreg.state_dict()
    # the round trip: each package restores the other's state bit-identically
    fresh = TRegistry()
    fresh.load_state(json.loads(json.dumps(jreg.state_dict())))
    assert fresh.state_dict() == jreg.state_dict()
    assert fresh.render() == jreg.render()
    fresh.counter("reqs_total", "requests\nby mode", labels=("mode",)).inc(mode="solo")
    assert fresh.get("reqs_total").value(mode="solo") == 2
    assert fresh.get("lat_seconds").count(mode="solo") == 4


def _random_metas(rng):
    """The reference's property-test metas (tests/test_continuous_batching.py)."""
    metas = []
    for _ in range(int(rng.integers(1, 11))):
        shape = (int(rng.integers(20, 3000)), int(rng.integers(8, 1000)),
                 int(rng.integers(2, 30)), int(rng.integers(2, 13)))
        steps = tuple(int(rng.integers(1, 61)) for _ in range(int(rng.integers(1, 9))))
        metas.append((shape, steps))
    return metas


@pytest.mark.parametrize("seed", range(6))
def test_pack_and_trial_flops_equal_the_reference(seed):
    metas = _random_metas(np.random.default_rng(seed))
    got = torchprof.pack_flops([TMeta(s, st) for s, st in metas])
    want = jaxprof.pack_flops([JMeta(s, st) for s, st in metas])
    assert got == want and got[0] >= got[1] > 0
    for (ntr, nval, d, c), steps in metas:
        for hidden in (32, 7):
            assert (TF.tabular_trial_flops(ntr, nval, d, c, steps[0], hidden)
                    == JF.tabular_trial_flops(ntr, nval, d, c, steps[0], hidden))


@pytest.mark.parametrize("mode", ["delta", "full"])
def test_gen_dst_generation_flops_equal_the_reference(mode):
    for phi, n, M, B, tile in ((100, 322, 23, 256, 8), (7, 20, 5, 13, 4), (1, 1, 1, 2, 8)):
        assert (TF.gen_dst_generation_flops(phi, n, M, B, mode=mode, tile_p=tile)
                == JF.gen_dst_generation_flops(phi, n, M, B, mode=mode, tile_p=tile))
    with pytest.raises(ValueError):
        TF.gen_dst_generation_flops(4, 4, 4, 4, mode="other")


def test_model_flops_equal_the_reference_for_every_config():
    """Every reference architecture (full and smoke), carried across with
    ``port_config``, and every ported architecture's own config, at every
    shape."""
    assert [s.name for s in T_SHAPES] == [s.name for s in J_SHAPES]
    families = set()
    for arch_id, jarch in JC.ARCHS.items():
        for jcfg in (jarch.config, jarch.smoke):
            tcfg = port_config(jcfg)
            families.add(tcfg.family)
            assert TF.active_params(tcfg) == JF.active_params(jcfg), arch_id
            for ts, js in zip(T_SHAPES, J_SHAPES):
                assert TF.model_flops(tcfg, ts) == JF.model_flops(jcfg, js), (arch_id, ts.name)
        if arch_id in TC.ARCHS:
            tarch = TC.get_arch(arch_id)
            for ts, js in zip(T_SHAPES, J_SHAPES):
                assert TF.model_flops(tarch.config, ts) == JF.model_flops(jarch.config, js)
    assert families >= {"dense", "ssm", "hybrid", "moe", "encdec", "vlm"}


def test_build_counters_keep_the_reference_protocol():
    torchprof.reset_tracing()
    try:
        snap = torchprof.tracing_snapshot()
        assert torchprof.new_tracings_since(snap) == {}
        torchprof.note_trace("masked_histogram")
        torchprof.note_trace("masked_histogram")
        torchprof.note_trace("ssd_scan")
        assert torchprof.new_tracings_since(snap) == {"masked_histogram": 2, "ssd_scan": 1}
        assert torchprof.total_tracings() == 3
        snap2 = torchprof.tracing_snapshot()
        assert torchprof.new_tracings_since(snap2) == {}
        text = torchprof.render_prometheus()
        assert 'torch_kernel_builds_total{site="masked_histogram"} 2' in text
    finally:
        torchprof.reset_tracing()


def test_prometheus_block_is_well_formed_and_counts_launches():
    kernels.reset_launch_counts()
    text = torchprof.render_prometheus()
    assert "# TYPE torch_kernel_builds_total counter" in text
    assert "# TYPE kernel_launches_total counter" in text
    assert 'torch_kernel_builds_total{site="none"} 0' in text
    for name in kernels.launch_counts():
        assert f'kernel_launches_total{{kernel="{name}"}} 0' in text
    for line in text.splitlines():
        assert line.startswith(("#", "torch_kernel_builds_total", "kernel_launches_total")), line


def test_dispatch_hook_opt_in():
    seen = []
    torchprof.set_dispatch_hook(lambda name, s, meta: seen.append((name, meta)))
    try:
        torchprof.dispatch_event("rung_dispatch", 0.1, mode="solo", jobs=1)
    finally:
        torchprof.set_dispatch_hook(None)
    torchprof.dispatch_event("ignored", 0.1)
    assert seen == [("rung_dispatch", {"mode": "solo", "jobs": 1})]
