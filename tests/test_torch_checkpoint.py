"""The port's ``distributed/checkpoint.py`` and ``distributed/fault.py`` held
to the JAX package's on the CPU.

Tolerances: none.  A checkpoint either package writes restores byte-equal in
the other, and the manifests are equal; shard placements and straggler sets
are equal on a seeded grid.
"""
import json

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
    with pytest.raises(TypeError, match="bfloat16"):
        tckpt.save_checkpoint(tmp_path, 0, {"w": torch.ones(2, dtype=torch.bfloat16)})


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
