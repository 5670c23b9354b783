"""The port's ``distributed/checkpoint.py`` and ``distributed/fault.py`` held
to the JAX package's on the CPU.

Tolerances: none.  A checkpoint either package writes restores byte-equal in
the other, and the manifests are equal, bfloat16 leaves included (stored as
the reference stores them, uint8 views with the logical dtype in the
manifest); a template-typed restore returns the template's structure,
devices and dtypes; shard placements and straggler sets are equal on a
seeded grid.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro.distributed import fault as jfault
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import fault as tfault


def _blob(seed, n=5000):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_uint8_blob_crosses_between_the_packages(tmp_path, writer):
    """The serving tier's checkpoint (one uint8 wire blob) written by one
    package is restored byte-equal by the other; both write the same
    manifest."""
    save, restore = ((jckpt.save_checkpoint, tckpt.restore_latest_untyped)
                     if writer == "reference" else
                     (tckpt.save_checkpoint, jckpt.restore_latest_untyped))
    blob = _blob(1)
    save(tmp_path / "a", 7, {"wire": blob})
    leaves, step = restore(tmp_path / "a")
    assert step == 7 and len(leaves) == 1
    assert leaves[0].dtype == np.uint8 and leaves[0].tobytes() == blob.tobytes()
    jckpt.save_checkpoint(tmp_path / "j", 7, {"wire": blob})
    tckpt.save_checkpoint(tmp_path / "t", 7, {"wire": blob})
    for name in ("manifest.json", "leaf_0.npy", "COMMIT"):
        assert ((tmp_path / "j" / "step_00000007" / name).read_bytes()
                == (tmp_path / "t" / "step_00000007" / name).read_bytes()), name


def test_nested_tree_manifest_equals_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"b": [rng.normal(size=(3, 4)).astype(np.float32), np.arange(5)],
            "a": (np.int32(7),), "c": {"z": np.ones(2, bool), "y": None}}
    jckpt.save_checkpoint(tmp_path / "j", 3, tree)
    tckpt.save_checkpoint(tmp_path / "t", 3, {"b": [torch.from_numpy(tree["b"][0]),
                                                    tree["b"][1]],
                                              "a": tree["a"], "c": tree["c"]})
    jm = json.loads((tmp_path / "j" / "step_00000003" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "t" / "step_00000003" / "manifest.json").read_text())
    assert tm == jm
    got, _ = tckpt.restore_latest_untyped(tmp_path / "j")
    want, _ = jckpt.restore_latest_untyped(tmp_path / "t")
    assert [a.tobytes() for a in got] == [b.tobytes() for b in want]


def test_uncommitted_checkpoint_ignored(tmp_path):
    tckpt.save_checkpoint(tmp_path, 1, {"wire": _blob(0)})
    fake = tmp_path / "step_00000005"
    fake.mkdir()
    (fake / "manifest.json").write_text("{}")   # no COMMIT
    assert tckpt.latest_step(tmp_path) == 1
    _, step = tckpt.restore_latest_untyped(tmp_path)
    assert step == 1
    assert tckpt.latest_step(tmp_path / "missing") is None
    assert tckpt.restore_latest_untyped(tmp_path / "missing") is None


def test_corruption_falls_back(tmp_path):
    tckpt.save_checkpoint(tmp_path, 1, {"wire": _blob(1)})
    tckpt.save_checkpoint(tmp_path, 2, {"wire": _blob(2)})
    leaf = tmp_path / "step_00000002" / "leaf_0.npy"
    leaf.write_bytes(b"garbage" + leaf.read_bytes()[7:])
    leaves, step = tckpt.restore_latest_untyped(tmp_path)
    assert step == 1, "must fall back to the intact checkpoint"
    assert leaves[0].tobytes() == _blob(1).tobytes()
    # the reference reads the port's directory the same way
    _, jstep = jckpt.restore_latest_untyped(tmp_path)
    assert jstep == 1


def test_retention(tmp_path):
    for s in range(6):
        tckpt.save_checkpoint(tmp_path, s, {"wire": _blob(s, 10)}, keep=3)
    kept = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_????????"))
    assert kept == [3, 4, 5]
    assert not list(tmp_path.glob("*.tmp"))


def test_dtype_numpy_lacks_is_refused(tmp_path):
    """A dtype numpy lacks (bfloat16) is no longer refused: each package
    restores the other's bfloat16 leaves bit for bit, from the same files
    (the reference's uint8-view format).  A dtype the port does not read
    still raises."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    bits = torch.from_numpy(w).to(torch.bfloat16)
    tree = {"w": bits, "s": torch.tensor([1.5, -2.0], dtype=torch.bfloat16), "n": np.arange(4)}
    tckpt.save_checkpoint(tmp_path / "t", 2, tree)
    leaves, step = jckpt.restore_latest_untyped(tmp_path / "t")
    assert step == 2 and [str(a.dtype) for a in leaves] == ["int64", "bfloat16", "bfloat16"]
    assert leaves[1].astype(np.float32).tolist() == [1.5, -2.0]
    np.testing.assert_array_equal(leaves[2].view(np.uint16),
                                  bits.view(torch.int16).numpy().view(np.uint16))
    jckpt.save_checkpoint(tmp_path / "j", 2, {"w": jnp.asarray(w, jnp.bfloat16),
                                              "s": jnp.asarray([1.5, -2.0], jnp.bfloat16),
                                              "n": np.arange(4)})
    for name in ("manifest.json", "leaf_0.npy", "leaf_1.npy", "leaf_2.npy", "COMMIT"):
        assert ((tmp_path / "j" / "step_00000002" / name).read_bytes()
                == (tmp_path / "t" / "step_00000002" / name).read_bytes()), name
    got, _ = tckpt.restore_latest_untyped(tmp_path / "j")
    assert got[2].dtype == torch.bfloat16 and got[2].shape == (3, 5)
    assert torch.equal(got[2].view(torch.int16), bits.view(torch.int16))
    assert got[1].dtype == torch.bfloat16 and got[1].tolist() == [1.5, -2.0]
    # a 0-d bfloat16 leaf (the reference cannot write one) is written flat;
    # the reference reads it back as 0-d
    tckpt.save_checkpoint(tmp_path / "z", 0, {"s": torch.tensor(1.5, dtype=torch.bfloat16)})
    (z,), _ = jckpt.restore_latest_untyped(tmp_path / "z")
    assert z.shape == () and float(z) == 1.5
    manifest = tmp_path / "t" / "step_00000002" / "manifest.json"
    m = json.loads(manifest.read_text())
    m["leaves"][2]["dtype"] = "float8_e4m3fn"
    manifest.write_text(json.dumps(m))
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tckpt.restore_latest_untyped(tmp_path / "t")


def test_restore_latest_is_typed_by_its_template(tmp_path):
    """A TrainState over Params (bfloat16 and float32 leaves, a step) comes
    back in the template's structure, dtypes and devices; a template whose
    shapes differ skips the checkpoint, and a corrupt newest one falls back
    to the older."""
    from repro_torch.models.layers import Params
    from repro_torch.train.train_step import TrainState

    def state(seed):
        g = torch.Generator().manual_seed(seed)
        params = Params({"embed": torch.randn(6, 4, generator=g).to(torch.bfloat16),
                         "layers": [{"w": torch.randn(4, 4, generator=g)} for _ in range(2)]})
        opt = {"m": [torch.randn(2, 4, 4, generator=g)]}
        return TrainState(torch.tensor(seed, dtype=torch.int32), params, opt)

    tckpt.save_checkpoint(tmp_path, 3, state(3))
    tckpt.save_checkpoint(tmp_path, 4, state(4))
    template = state(0)
    template.params.embed.data = template.params.embed.data.float()
    restored, step = tckpt.restore_latest(tmp_path, template)
    want = state(4)
    assert step == 4 and isinstance(restored, TrainState) and int(restored.step) == 4
    assert restored.params["embed"].dtype == torch.float32
    assert torch.equal(restored.params["embed"], want.params["embed"].float())
    assert torch.equal(restored.params["layers"][1]["w"], want.params["layers"][1]["w"])
    assert torch.equal(restored.opt_state["m"][0], want.opt_state["m"][0])
    # the reference restores the same files untyped
    jleaves, _ = jckpt.restore_latest_untyped(tmp_path)
    assert str(jleaves[1].dtype) == "bfloat16" and len(jleaves) == 5
    leaf = tmp_path / "step_00000004" / "leaf_2.npy"
    leaf.write_bytes(b"garbage" + leaf.read_bytes()[7:])
    _, step = tckpt.restore_latest(tmp_path, template)
    assert step == 3
    wrong = state(0)
    wrong.opt_state["m"][0] = torch.zeros(3, 4, 4)
    assert tckpt.restore_latest(tmp_path, wrong) is None
    assert tckpt.restore_latest(tmp_path / "missing", template) is None


def test_checkpoint_manager_writes_asynchronously(tmp_path):
    """save_async copies to the host and writes on a thread; the step's
    values are the ones at the call, whatever the caller changes after;
    keep prunes; a failed write raises at wait()."""
    mgr = tckpt.CheckpointManager(tmp_path / "c", keep=2)
    x = torch.arange(6, dtype=torch.float32)
    for step in range(3):
        mgr.save_async(step, {"x": x, "b": x.to(torch.bfloat16)})
        x.add_(10)                       # the state moves on while the write runs
    mgr.wait()
    assert tckpt.latest_step(tmp_path / "c") == 2
    kept = sorted(p.name for p in (tmp_path / "c").glob("step_????????"))
    assert kept == ["step_00000001", "step_00000002"]
    template = {"b": torch.zeros(6, dtype=torch.bfloat16), "x": torch.zeros(6)}
    restored, step = tckpt.restore_latest(tmp_path / "c", template)
    assert step == 2
    assert torch.equal(restored["x"], torch.arange(6, dtype=torch.float32) + 20)
    assert torch.equal(restored["b"], (torch.arange(6) + 20).to(torch.bfloat16))
    (tmp_path / "file").write_text("not a directory")
    bad = tckpt.CheckpointManager(tmp_path / "file")
    bad.save_async(0, {"x": x})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                           # the error is raised once


# ---------------------------------------------------------------------------
# fault: shard placement and stragglers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_assign_shards_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hosts = int(rng.integers(1, 9))
        alive = sorted(set(rng.choice(hosts, int(rng.integers(1, hosts + 1)),
                                      replace=False).tolist()))
        shards = int(rng.integers(0, 40))
        got = tfault.assign_shards(shards, alive, hosts)
        assert got == jfault.assign_shards(shards, alive, hosts)
        assert set(got.values()) <= set(alive) and sorted(got) == list(range(shards))
    with pytest.raises(ValueError, match="no alive hosts"):
        tfault.assign_shards(3, [], 2)


@pytest.mark.parametrize("seed", range(3))
def test_heartbeat_stragglers_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 8))
        factor = float(rng.uniform(1.5, 4.0))
        th, jh = tfault.Heartbeat(n, factor), jfault.Heartbeat(n, factor)
        for h in range(n):
            dt = float(rng.exponential(1.0)) * (10.0 if rng.random() < 0.2 else 1.0)
            th.beat(h, dt)
            jh.beat(h, dt)
        assert th.stragglers() == jh.stragglers()
        assert th.dead(timeout_s=3600.0) == [] and sorted(th.last_seen) == list(range(n))


def _state():
    """The reference's ``tests/test_checkpoint.py`` fixture, as tensors."""
    return {"step": torch.tensor(7, dtype=torch.int32),
            "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "opt": [torch.zeros((3, 4)), {"v": torch.full((2,), 5.0)}]}


def test_resharded_restore(tmp_path):
    """``tests/test_checkpoint.py:84-93`` on the port: restored onto a
    one-device mesh, every leaf replicated, its value and dtype the saved
    ones; and onto a reference checkpoint of the same tree."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.sharding import PartitionSpec, tree_shardings
    from _torch_port import fake_mesh
    state = _state()
    tckpt.save_checkpoint(tmp_path / "t", 4, state)
    jckpt.save_checkpoint(tmp_path / "j", 4, {
        "step": jnp.int32(7), "params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                                         "b": jnp.ones((4,), jnp.bfloat16)},
        "opt": [jnp.zeros((3, 4)), {"v": jnp.full((2,), 5.0)}]})
    specs = {"step": PartitionSpec(), "params": {"w": PartitionSpec(None, None),
                                                 "b": PartitionSpec(None)},
             "opt": [PartitionSpec(None, None), {"v": PartitionSpec(None)}]}
    with fake_mesh((1,), ("data",)) as mesh:
        for path in ("t", "j"):
            restored, step = tckpt.restore_resharded(tmp_path / path, state,
                                                     tree_shardings(specs, mesh))
            assert step == 4
            w = restored["params"]["w"]
            assert isinstance(w, DTensor) and tuple(w.placements) == (Replicate(),)
            for got, want in ((w, state["params"]["w"]), (restored["params"]["b"],
                                                          state["params"]["b"]),
                              (restored["opt"][1]["v"], state["opt"][1]["v"])):
                assert got.dtype == want.dtype
                torch.testing.assert_close(got.to_local(), want, rtol=0, atol=0)
        assert tckpt.restore_resharded(tmp_path / "missing", state,
                                       tree_shardings(specs, mesh)) is None


def test_resharded_restore_onto_a_2x4_fake_mesh(tmp_path):
    """A training state's checkpoint restored onto a (2, 4) mesh's placements
    from the sharding rules: each leaf a DTensor of the saved global shape
    with its spec's placements, and this rank's shard the saved tensor's
    block at mesh coordinate (0, 0)."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.distributed import sharding as tsh
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import TrainState, init_train_state
    from _torch_port import fake_mesh
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke, dtype=torch.float32)
    opt = topt.adamw(lambda s: 1e-3)
    state = init_train_state(make_generator(0), cfg, opt)
    tckpt.save_checkpoint(tmp_path, 2, state)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        pspecs = tsh.param_specs(state.params, cfg, mesh, tsh.rules_for(cfg, mesh, "train"))
        specs = TrainState(tsh.PartitionSpec(), pspecs,
                           tsh.opt_state_specs(state.opt_state, pspecs, state.params, mesh))
        shardings = tsh.tree_shardings(specs, mesh)
        restored, step = tckpt.restore_resharded(tmp_path, state, shardings)
    assert step == 2
    saved, got, want = [], [], []
    tckpt._flatten(state, saved)
    tckpt._flatten(restored, got)
    tckpt._flatten(shardings, want)
    assert len(saved) == len(got) == len(want) > 10
    n_sharded = 0
    for s, g, sh in zip(saved, got, want):
        assert isinstance(g, DTensor) and g.shape == s.shape and g.dtype == s.dtype
        assert tuple(g.placements) == sh.placements
        block = s
        for mesh_dim, p in enumerate(sh.placements):
            if p.is_shard():
                size = -(-block.shape[p.dim] // mesh.shape[mesh_dim])
                block = block.narrow(p.dim, 0, min(size, block.shape[p.dim]))
                n_sharded += 1
        torch.testing.assert_close(g.to_local(), block, rtol=0, atol=0)
    assert n_sharded > 0


_RESHARD_8 = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.device import make_generator
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import sharding as tsh
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainState, init_train_state
cfg = dataclasses.replace(get_arch("zamba2-2.7b").smoke, dtype=torch.float32)
opt = topt.adafactor(lambda s: 1e-3)
state = init_train_state(make_generator(0), cfg, opt)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
pspecs = tsh.param_specs(state.params, cfg, mesh, tsh.rules_for(cfg, mesh, "train"))
specs = TrainState(tsh.PartitionSpec(), pspecs,
                   tsh.opt_state_specs(state.opt_state, pspecs, state.params, mesh))
restored, step = tckpt.restore_resharded({ckpt!r}, state, tsh.tree_shardings(specs, mesh))
saved, got = [], []
tckpt._flatten(state, saved)
tckpt._flatten(restored, got)
same = all(torch.equal(g.full_tensor(), s) for s, g in zip(saved, got))
sharded = sum(any(p.is_shard() for p in g.placements) for g in got)
print(json.dumps({{"step": step, "same": same, "leaves": len(got), "sharded": sharded}}))
"""


def test_resharded_restore_on_8_gloo_ranks(tmp_path):
    """zamba2's smoke training state (Adafactor) restored onto a (2, 4) gloo
    mesh by the rules' placements: on every rank, every leaf's global value
    is the saved one."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.device import make_generator
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import init_train_state
    from _torch_port import run_ranks
    cfg = dataclasses.replace(get_arch("zamba2-2.7b").smoke, dtype=torch.float32)
    state = init_train_state(make_generator(0), cfg, topt.adafactor(lambda s: 1e-3))
    tckpt.save_checkpoint(tmp_path / "ckpt", 5, state)
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in run_ranks(_RESHARD_8.format(ckpt=str(tmp_path / "ckpt")), 8, tmp_path)]
    assert all(o == {"step": 5, "same": True, "leaves": outs[0]["leaves"],
                     "sharded": outs[0]["sharded"]} for o in outs), outs
    assert outs[0]["sharded"] > 0
