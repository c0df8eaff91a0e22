"""The port's checkpoint layer (`repro_torch.checkpoint.manager`), mirroring
`tests/test_checkpoint.py`: atomicity, async saves with keep-k GC, the
manifest's dtype over a drifted leaf file, junk in the directory, an async
error surfacing on `wait`, GC under a concurrent restore. The reference's
reshard-on-load becomes a device move (CPU to CPU here; onto the card in
the `cuda` case).

The cross-package cases hold the two packages to one format: a tree saved
by the JAX manager restores into the port bit for bit and the other way
round, and a `ServiceState` flattens to the reference's keys, leaf order,
dtypes and shapes. They import the JAX package inside the test, so this
file also runs (its `cuda` case) where only PyTorch is installed:

    PYTHONPATH=src:tests python -m pytest -q --noconftest -m cuda tests/test_torch_checkpoint.py
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.checkpoint import manager as ckpt


def _tree(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g).to(device),
                   "b": torch.randn(16, generator=g).to(device)},
        "opt": {"m": torch.zeros(8, 16, device=device),
                "step": torch.tensor(3, dtype=torch.int32, device=device)},
        "host": np.arange(5, dtype=np.int64) * seed,
    }


def _assert_tree_equal(a, b):
    la, lb = pytree.flatten_with_paths(a), pytree.flatten_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), key
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extras={"note": "x"})
    out = ckpt.restore(str(tmp_path), 7, t)
    _assert_tree_equal(t, out)
    assert ckpt.read_extras(str(tmp_path), 7)["note"] == "x"
    assert ckpt.latest_step(str(tmp_path)) == 7
    keys = [e["key"] for e in json.loads(
        (tmp_path / "step_00000007" / "manifest.json").read_text())["leaves"]]
    assert keys == ["host", "opt/m", "opt/step", "params/b", "params/w"]


def test_atomicity_partial_save_ignored(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    # a crash mid-save: a stale .tmp directory and a step directory without
    # a manifest are both ignored
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert ckpt.latest_step(str(tmp_path)) == 1
    _assert_tree_equal(t, ckpt.restore(str(tmp_path), 1, t))


def test_manager_async_and_gc(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in [10, 20, 30, 40]:
        m.save_async(s, _tree(s))
    m.wait()
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000030", "step_00000040"]
    _assert_tree_equal(_tree(40), m.restore(_tree(40)))


def test_save_async_copies_before_the_thread(tmp_path):
    """The host copy is taken before `save_async` returns: writes to the
    caller's tensors and arrays afterwards do not reach the checkpoint."""
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    t = _tree(5)
    want = pytree.tree_map_with_path(lambda _k, x: x.clone() if torch.is_tensor(x)
                                     else x.copy(), t)
    m.save_async(1, t)
    t["params"]["w"].add_(1.0)
    t["host"][:] = -1
    m.wait()
    _assert_tree_equal(want, m.restore(want))


def test_save_overwrites_same_step(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    ckpt.save(str(tmp_path), 5, t1)
    ckpt.save(str(tmp_path), 5, t2)
    _assert_tree_equal(t2, ckpt.restore(str(tmp_path), 5, t1))


def test_shape_mismatch_rejected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = dict(t, params={"w": torch.zeros(4, 4), "b": t["params"]["b"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad)


def test_restore_casts_to_manifest_dtype(tmp_path):
    """The manifest's dtype is authoritative: a leaf file rewritten at
    float64 restores as float32, onto either device argument."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    step_dir = tmp_path / "step_00000001"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    entry = next(e for e in manifest["leaves"] if e["key"] == "params/w")
    assert entry["dtype"] == "float32"
    np.save(step_dir / entry["file"], np.load(step_dir / entry["file"]).astype(np.float64))
    out = ckpt.restore(str(tmp_path), 1, t)
    assert out["params"]["w"].dtype == torch.float32
    moved = ckpt.restore(str(tmp_path), 1, t, device="cpu")
    assert moved["params"]["w"].dtype == torch.float32
    _assert_tree_equal(out, moved)
    _assert_tree_equal(t, out)


def test_discovery_survives_junk_step_names(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    ckpt.save(str(tmp_path), 7, t)
    os.makedirs(tmp_path / "step_backup")
    os.makedirs(tmp_path / "step_12abc")
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "notes.txt").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.valid_steps(str(tmp_path)) == [7, 3]
    m = ckpt.CheckpointManager(str(tmp_path), keep=1)
    m._gc()  # must not raise, must not touch the junk
    assert ckpt.valid_steps(str(tmp_path)) == [7]
    assert (tmp_path / "step_backup").is_dir()
    _assert_tree_equal(t, m.restore(_tree()))


def test_manager_async_error_surfaces_on_wait(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    # extras that cannot be JSON-serialized make the worker raise
    m.save_async(1, _tree(), extras={"bad": object()})
    with pytest.raises(TypeError):
        m.wait()
    m.wait()  # consumed, not sticky
    m.save_async(2, _tree(2))
    assert m.latest() == 2
    _assert_tree_equal(_tree(2), m.restore(_tree()))


def test_gc_never_deletes_step_under_concurrent_restore(tmp_path, monkeypatch):
    t = _tree()
    m = ckpt.CheckpointManager(str(tmp_path), keep=1)
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, _tree(2))
    in_read, resume = threading.Event(), threading.Event()
    real_restore = ckpt.restore

    def slow_restore(directory, step, like, device=None):
        in_read.set()
        assert resume.wait(timeout=30)
        return real_restore(directory, step, like, device)

    monkeypatch.setattr(ckpt, "restore", slow_restore)
    result = {}
    reader = threading.Thread(target=lambda: result.update(out=m.restore(_tree(), step=1)))
    reader.start()
    assert in_read.wait(timeout=30)
    m._gc()  # would delete step 1 (keep=1), but a reader holds it
    assert (tmp_path / "step_00000001" / "manifest.json").exists()
    resume.set()
    reader.join(timeout=30)
    assert not reader.is_alive()
    _assert_tree_equal(t, result["out"])
    m._gc()  # the reader is gone: now it is collectable
    assert not (tmp_path / "step_00000001").exists()
    assert (tmp_path / "step_00000002").exists()


def test_restore_moves_leaves_to_the_device(tmp_path):
    """The reference's reshard-on-load as a device move: tensor leaves go
    to `device`, numpy leaves stay on the host."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    out = ckpt.restore(str(tmp_path), 1, t, device="cpu")
    _assert_tree_equal(t, out)
    for key, leaf in pytree.flatten_with_paths(out):
        assert (leaf.device.type == "cpu") if torch.is_tensor(leaf) else key == "host"


@pytest.mark.cuda
def test_restore_moves_leaves_onto_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    on_card = ckpt.restore(str(tmp_path), 1, t, device="cuda")
    for _key, leaf in pytree.flatten_with_paths(on_card):
        assert not torch.is_tensor(leaf) or leaf.is_cuda
    _assert_tree_equal(t, on_card)
    # a card-resident tree saves the same files and restores to the CPU
    ckpt.save(str(tmp_path), 2, on_card)
    back = ckpt.restore(str(tmp_path), 2, t)
    for _key, leaf in pytree.flatten_with_paths(back):
        assert not torch.is_tensor(leaf) or leaf.device.type == "cpu"
    _assert_tree_equal(t, back)
    first, second = tmp_path / "step_00000001", tmp_path / "step_00000002"
    assert (json.loads((first / "manifest.json").read_text())["leaves"]
            == json.loads((second / "manifest.json").read_text())["leaves"])
    for leaf in first.glob("leaf_*.npy"):
        assert leaf.read_bytes() == (second / leaf.name).read_bytes(), leaf.name


def test_bfloat16_leaf_is_a_typed_error(tmp_path):
    """A dtype the other package cannot read without `ml_dtypes` raises
    `CheckpointDtypeError` on save and leaves no checkpoint."""
    with pytest.raises(ckpt.CheckpointDtypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 1, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 2, {"w": torch.ones(4)})
    manifest_path = tmp_path / "step_00000002" / "manifest.json"
    manifest = json.loads(manifest_path.read_text())
    manifest["leaves"][0]["dtype"] = "bfloat16"
    manifest_path.write_text(json.dumps(manifest))
    with pytest.raises(ckpt.CheckpointDtypeError):
        ckpt.restore(str(tmp_path), 2, {"w": torch.zeros(4)})


def test_unflatten_rejects_a_wrong_leaf_count():
    like = {"a": torch.zeros(2), "b": [np.zeros(1), 3]}
    assert [k for k, _ in pytree.flatten_with_paths(like)] == ["a", "b/0", "b/1"]
    with pytest.raises(ValueError, match="fewer"):
        pytree.unflatten(like, [1, 2])
    with pytest.raises(ValueError, match="more"):
        pytree.unflatten(like, [1, 2, 3, 4])


# -- the two packages, one format ----------------------------------------------------


def _jax_side():
    jax = pytest.importorskip("jax")
    from repro.checkpoint import manager as jckpt
    return jax, jckpt


def _jax_tree(seed=0):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.normal(size=(8, 16)), jnp.float32),
                   "b": jnp.asarray(rng.normal(size=(16,)), jnp.float32)},
        "opt": {"m": jnp.asarray(rng.normal(size=(8, 16)), jnp.float32),
                "step": jnp.asarray(3, jnp.int32),
                "seen": jnp.asarray(rng.random(7) > 0.5)},
        "host": np.arange(5, dtype=np.int64),
    }


def _as_port(jtree):
    return {"params": {k: torch.from_numpy(np.asarray(v).copy())
                       for k, v in jtree["params"].items()},
            "opt": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jtree["opt"].items()},
            "host": np.asarray(jtree["host"]).copy()}


def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path):
    jax, jckpt = _jax_side()
    jt = _jax_tree(1)
    jckpt.save(str(tmp_path), 4, jt, extras={"from": "jax"})
    like = pytree.tree_map_with_path(
        lambda _k, x: torch.zeros_like(x) if torch.is_tensor(x) else np.zeros_like(x),
        _as_port(jt))
    out = ckpt.restore(str(tmp_path), 4, like)
    _assert_tree_equal(_as_port(jt), out)
    assert ckpt.read_extras(str(tmp_path), 4) == {"from": "jax"}
    assert ckpt.valid_steps(str(tmp_path)) == jckpt.valid_steps(str(tmp_path))


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path):
    jax, jckpt = _jax_side()
    jt = _jax_tree(2)
    ckpt.save(str(tmp_path / "port"), 4, _as_port(jt))
    jckpt.save(str(tmp_path / "jax"), 4, jt)
    like = jax.tree.map(lambda x: np.zeros_like(np.asarray(x)), jt)
    # JAX reading the port's checkpoint == JAX reading its own
    out = jckpt.restore(str(tmp_path / "port"), 4, like)
    own = jckpt.restore(str(tmp_path / "jax"), 4, like)
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_flatten_with_path(out)[0],
                                jax.tree_util.tree_flatten_with_path(own)[0]):
        assert ka == kb and np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the two packages write the same files, byte for byte
    a, b = tmp_path / "port" / "step_00000004", tmp_path / "jax" / "step_00000004"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_service_state_flattens_to_the_references_keys(tiny_tree):
    """The port's `ServiceState` (and a snapshot's host dict) flattens to
    the keys, leaf order, dtypes and shapes of the reference's manifests:
    `.field` for a dataclass field, bare sorted dict keys."""
    _jax, jckpt = _jax_side()
    from _torch_parity import to_torch_tree
    from repro.core.pipeline import SessionConfig as JConfig
    from repro.serve import lod_service as jsvc
    from repro_torch.core.pipeline import SessionConfig as TConfig
    from repro_torch.serve import lod_service as tsvc
    jcfg = JConfig(tau=24.0, cut_budget=2048)
    js = jsvc.LodService(tiny_tree, jcfg, 2, focal=1400.0, capacity=4)
    ts = tsvc.LodService(to_torch_tree(tiny_tree), TConfig(**dataclasses.asdict(jcfg)), 2,
                         focal=1400.0, capacity=4, device="cpu")
    host = {"b": np.zeros(3, np.float32), "a": np.ones((2, 2), bool)}
    jitems, _ = jckpt._flatten_with_paths({"state": js.state, "host": host})
    titems = pytree.flatten_with_paths({"state": ts.state, "host": host})
    assert len(titems) == len(jitems) == 18
    assert titems[2][0] == "state/.mgr/.client_has" and titems[-1][0] == "state/.fleet/.next_id"
    for (tk, tv), (jk, jv) in zip(titems, jitems):
        tv = tv.numpy() if torch.is_tensor(tv) else tv
        assert tk == jk
        assert (str(tv.dtype), tv.shape) == (str(np.asarray(jv).dtype), np.asarray(jv).shape), tk
