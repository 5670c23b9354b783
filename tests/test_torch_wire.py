"""The port's ``service/wire.py`` held to the JAX package's on the CPU, and
the port's ``search_snapshot``/``search_restore`` across a real process
boundary.

Tolerances: none for the format — a numpy tree gives byte-equal ``dumps``
in both packages, each package's ``loads`` reads the other's, and a tensor
encodes to the bytes of its numpy array.  A search resumed in a fresh
interpreter gives the uninterrupted run's winner spec and trial accuracies
within 1e-6 (as ``tests/test_wire.py`` holds the reference).
"""
import dataclasses
import json
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.gen_dst import GenDSTConfig as JGenDSTConfig
from repro.service import wire as jwire
from repro_torch.automl.engine import (
    AutoMLConfig, search_eval_rung, search_init, search_restore, search_result,
    search_snapshot,
)
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.core.measures import factorize
from repro_torch.core.plan import plan
from repro_torch.service import wire

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _roundtrip(obj):
    return wire.loads(wire.dumps(obj))


# ---------------------------------------------------------------------------
# exact round-trips (tests/test_wire.py on the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint8, np.uint32, np.bool_])
def test_int_index_tensors_roundtrip_exact(dtype):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 100, size=(7, 3)).astype(dtype)
    for obj in (arr, torch.from_numpy(arr)):
        out = _roundtrip(obj)
        assert isinstance(out, np.ndarray)
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_float_tensors_roundtrip_bit_exact(dtype):
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(5, 4)).astype(dtype)
    for obj in (arr, torch.from_numpy(arr)):
        out = _roundtrip(obj)
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(
            out.view(np.uint8), np.ascontiguousarray(arr).view(np.uint8))


def test_strided_and_grad_tensors_roundtrip():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    view = base[:, ::2].t()                      # not contiguous
    np.testing.assert_array_equal(_roundtrip(view), view.numpy())
    w = torch.ones(3, requires_grad=True)
    np.testing.assert_array_equal(_roundtrip(w * 2), np.full(3, 2.0, np.float32))


def test_empty_and_scalar_arrays():
    empty = np.empty((0, 5), np.int64)
    out = _roundtrip(empty)
    assert out.shape == (0, 5) and out.dtype == np.int64
    scalar = np.float32(2.5)
    back = _roundtrip(scalar)
    assert isinstance(back, np.floating) and back == scalar


def test_decoded_arrays_are_writable_copies():
    arr = np.arange(6, dtype=np.int32)
    out = _roundtrip(arr)
    out[0] = 99
    assert arr[0] == 0


def test_nested_structures_roundtrip():
    obj = {
        "ints": np.arange(4, dtype=np.int64),
        "tup": (1, "two", 3.0, None, True),
        "nested": [{"k": (np.float32(1.5), b"raw-bytes")}],
        7: "non-string-key",
    }
    out = _roundtrip(obj)
    assert out["tup"] == (1, "two", 3.0, None, True)
    assert out["nested"][0]["k"][1] == b"raw-bytes"
    assert out[7] == "non-string-key"
    np.testing.assert_array_equal(out["ints"], obj["ints"])


def test_port_dataclasses_and_namedtuples_roundtrip():
    p = plan("gen_dst", n=32, m=4,
             sub_automl=AutoMLConfig(n_trials=6, rungs=(2, 4)), psi=5)
    assert _roundtrip(p) == p
    cfg = GenDSTConfig(psi=3, phi=8, measure="ig")
    assert _roundtrip(cfg) == cfg
    rng = np.random.default_rng(0)
    coded = factorize(rng.normal(size=(20, 4)).astype(np.float32),
                      (np.arange(20) % 2).astype(np.int64), device="cpu")
    back = _roundtrip(coded)
    assert type(back).__name__ == "CodedDataset"   # typed, not a bare tuple
    np.testing.assert_array_equal(back.codes, coded.codes.numpy())
    assert back.target_col == coded.target_col


def test_kind_tag_peek():
    blob = wire.dumps({"x": 1}, kind="task")
    assert wire.kind_of(blob) == "task"
    assert wire.trace_of(blob) is None
    assert wire.trace_of(wire.dumps(1, trace={"trace_id": "t", "parent": "p"})) == {
        "trace_id": "t", "parent": "p"}


# ---------------------------------------------------------------------------
# rejection paths
# ---------------------------------------------------------------------------


def test_unknown_version_rejected_with_clear_error():
    blob = bytearray(wire.dumps({"x": 1}))
    struct.pack_into("<I", blob, 4, wire.WIRE_VERSION + 1)
    with pytest.raises(wire.WireVersionError) as exc:
        wire.loads(bytes(blob))
    assert str(wire.WIRE_VERSION + 1) in str(exc.value)
    assert str(wire.WIRE_VERSION) in str(exc.value)


def test_bad_magic_rejected():
    blob = b"XXXX" + wire.dumps({"x": 1})[4:]
    with pytest.raises(wire.WireError, match="magic"):
        wire.loads(blob)


def test_truncated_payload_rejected():
    blob = wire.dumps(np.arange(100, dtype=np.int64))
    with pytest.raises(wire.WireError, match="truncated"):
        wire.loads(blob[:-8])
    with pytest.raises(wire.WireError):
        wire.loads(blob[:6])


def test_callables_rejected_by_name():
    with pytest.raises(wire.WireError, match="not wire-serializable"):
        wire.dumps({"thunk": lambda: 1})


def test_foreign_dataclass_rejected():
    @dataclasses.dataclass
    class NotOurs:
        x: int = 1

    with pytest.raises(wire.WireError, match="non-repro"):
        wire.dumps(NotOurs())


def test_decode_refuses_foreign_module_tags():
    blob = wire.dumps(GenDSTConfig())
    tag = b"repro_torch.core.gen_dst"
    evil = blob.replace(tag, b"os.path:".ljust(len(tag) - 4, b":") + b"juno")
    with pytest.raises(wire.WireError, match="non-repro_torch"):
        wire.loads(evil)


def _key_payload():
    """A reference payload holding a JAX PRNG key (a ``__key__`` node)."""
    import jax
    return jwire.dumps({"key": jax.random.key(3)})


@pytest.mark.parametrize("case", ["repro_tag", "key_node", "bfloat16", "generator"])
def test_what_the_port_does_not_carry_raises_by_name(case):
    if case == "repro_tag":        # the reference's own dataclass
        with pytest.raises(wire.WireError, match="repro.core.gen_dst"):
            wire.loads(jwire.dumps(JGenDSTConfig()))
    elif case == "key_node":
        with pytest.raises(wire.WireError, match="__key__"):
            wire.loads(_key_payload())
    elif case == "bfloat16":
        with pytest.raises(wire.WireError, match="bfloat16"):
            wire.dumps({"w": torch.ones(3, dtype=torch.bfloat16)})
    else:
        with pytest.raises(wire.WireError, match="Generator"):
            wire.dumps([torch.Generator().manual_seed(1)])


def test_refused_repro_tag_imports_nothing_of_the_reference(tmp_path):
    """Decoding a ``"repro."``-tagged payload in a fresh interpreter raises
    before anything is imported: ``jax`` and ``repro`` stay out."""
    blob = tmp_path / "ref.wire"
    blob.write_bytes(jwire.dumps({"cfg": JGenDSTConfig(), "x": np.arange(3)}))
    script = textwrap.dedent(f"""
        import sys
        from repro_torch.service import wire
        try:
            wire.loads(open({str(blob)!r}, "rb").read())
        except wire.WireError as e:
            print("refused:", e)
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "repro"))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "refused:" in proc.stdout and "repro.core.gen_dst" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "BAD []"


# ---------------------------------------------------------------------------
# the format is the reference's
# ---------------------------------------------------------------------------


def _numpy_trees():
    rng = np.random.default_rng(7)
    return [
        {"X": rng.normal(size=(9, 4)).astype(np.float32),
         "y": rng.integers(0, 3, 9), "tenant": "acme", "seed": 4, "plan": None},
        [np.int32(5), np.float64(-0.5), np.bool_(True), b"\x00\x01", (1, 2.5, None)],
        {3: (np.empty((0, 2), np.uint8), [np.arange(5, dtype=np.int16)]),
         "nan": float("nan"), "big": 2 ** 62, "s": "é"},
        np.asfortranarray(rng.normal(size=(3, 5))),
        np.float16(1.25),
    ]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    if isinstance(a, float) and a != a:
        return b != b
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("i", range(5))
def test_numpy_tree_bytes_equal_the_reference_and_cross_load(i):
    tree = _numpy_trees()[i]
    for kw in ({}, {"kind": "task", "trace": {"trace_id": "ab", "parent": "dispatch"}}):
        blob = wire.dumps(tree, **kw)
        assert blob == jwire.dumps(tree, **kw)
        assert _same(wire.loads(blob), jwire.loads(blob))
        assert _same(jwire.loads(blob), tree if not isinstance(tree, np.ndarray)
                     else np.ascontiguousarray(tree))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64, np.int32, np.uint8,
                                   np.bool_, np.float16])
def test_tensor_encodes_to_the_bytes_of_its_array(dtype):
    a = (np.random.default_rng(3).normal(size=(4, 3)) * 10).astype(dtype)
    tree = {"a": a, "s": [a[0], 1]}
    ttree = {"a": torch.from_numpy(a), "s": [torch.from_numpy(a[0]), 1]}
    assert wire.dumps(ttree) == wire.dumps(tree) == jwire.dumps(tree)


# ---------------------------------------------------------------------------
# SearchState snapshots: in-process and across a real process boundary
# ---------------------------------------------------------------------------


def _mini_search(seed=0, N=48, d=6, c=3, **kw):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, d)).astype(np.float32)
    y = (np.arange(N) % c).astype(np.int64)
    return search_init(X, y, config=AutoMLConfig(n_trials=6, rungs=(2, 4)),
                       device="cpu", **kw)


def _finish(st):
    while not st.done:
        search_eval_rung(st)
    return search_result(st)


def test_search_snapshot_roundtrip_in_process():
    want = _finish(_mini_search())
    st = _mini_search()
    search_eval_rung(st)                       # mid-search: one rung recorded
    snap = wire.loads(wire.dumps(search_snapshot(st), kind="search"))
    resumed = search_restore(snap, "cpu")
    assert resumed.ctx["device"] == torch.device("cpu")
    assert resumed.ctx["y_tr_t"].dtype == torch.int64
    got = _finish(resumed)
    assert got.spec == want.spec
    np.testing.assert_allclose([v for _, v in got.trials],
                               [v for _, v in want.trials], atol=1e-6)
    assert all(isinstance(x, torch.Tensor)
               for x in torch.utils._pytree.tree_leaves(got.params))


def test_finished_search_snapshot_keeps_tensor_params():
    """A snapshot taken after the last rung materializes the winner's lazy
    params; restored, they are tensors again and score the same."""
    st = _mini_search()
    want = _finish(st)
    resumed = search_restore(wire.loads(wire.dumps(search_snapshot(st))), "cpu")
    got = search_result(resumed)
    assert got.spec == want.spec and got.val_acc == want.val_acc
    for a, b in zip(torch.utils._pytree.tree_leaves(got.params),
                    torch.utils._pytree.tree_leaves(want.params)):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def test_search_with_init_provider_refuses_snapshot():
    st = _mini_search(init_provider=lambda *a: None)
    with pytest.raises(wire.WireError, match="init_provider"):
        search_snapshot(st)


def test_search_snapshot_resumes_in_fresh_process(tmp_path):
    """A mid-rung SearchState wired to disk finishes in a fresh interpreter
    (nothing of JAX imported) with the uninterrupted run's winner and trial
    accuracies."""
    want = _finish(_mini_search())
    st = _mini_search()
    search_eval_rung(st)
    blob_path = tmp_path / "search.wire"
    blob_path.write_bytes(wire.dumps(search_snapshot(st), kind="search"))

    script = textwrap.dedent(f"""
        import json, sys
        from repro_torch.automl.engine import (search_eval_rung, search_restore,
                                               search_result)
        from repro_torch.service import wire
        st = search_restore(wire.loads(open({str(blob_path)!r}, "rb").read()), "cpu")
        while not st.done:
            search_eval_rung(st)
        res = search_result(st)
        print(json.dumps({{
            "spec": [res.spec.preproc, res.spec.feature_frac,
                     res.spec.family, list(map(list, res.spec.hp))],
            "trials": [float(v) for _, v in res.trials],
            "bad": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "repro")),
        }}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["spec"][0] == want.spec.preproc
    assert got["spec"][1] == pytest.approx(want.spec.feature_frac)
    assert got["spec"][2] == want.spec.family
    assert tuple(tuple(kv) for kv in got["spec"][3]) == tuple(
        tuple(kv) for kv in want.spec.hp)
    np.testing.assert_allclose(got["trials"], [v for _, v in want.trials], atol=1e-6)
