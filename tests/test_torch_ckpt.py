"""The port's checkpoint store and crash/restore runner, on the CPU.

Replays tests/test_ckpt_runtime.py on ``repro_torch`` (store round trip and
single write, GC, reload from disk, the crash -> restore -> bit-identical
losses drill, stragglers, restore into a fresh template, restart-safe
data), then holds the two packages' stores to one file format: a
checkpoint saved by either restores byte-equal in the other, and the same
tree gives byte-equal ``.vlog`` files and manifests from both.
"""
import os
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.nezha_store import NezhaCheckpointStore as JaxStore
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get as jax_get
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.launch.mesh import make_host_mesh
from repro_torch.ckpt.nezha_store import NezhaCheckpointStore
from repro_torch.configs import ShapeConfig, get
from repro_torch.convert import params_from_numpy
from repro_torch.core.metrics import Metrics
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import abstract_state, make_init_fn
from repro_torch.runtime.coordinator import Coordinator, TrainRunner
from repro_torch.utils import tree_bytes, tree_leaves, tree_paths

SHAPE = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")


def tiny_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((64, 32), generator=g),
            "b": {"w": torch.randn((8,), generator=g),
                  "s": torch.zeros((), dtype=torch.int32)}}


def mixed_tree(seed=0):
    """bf16, f32 and int32 leaves, nested dicts and a tuple, in numpy (for
    the JAX store) and torch (for the port's), holding the same bits."""
    rng = np.random.default_rng(seed)
    bf = jnp.asarray(rng.standard_normal((3, 5, 8)), jnp.bfloat16)
    np_tree = {
        "w": {"z_bf16": np.asarray(bf),
              "a_f32": rng.standard_normal((7, 4)).astype(np.float32)},
        "stack": (rng.integers(-9, 9, (2, 3)).astype(np.int32),
                  np.asarray(jnp.ones((4,), jnp.bfloat16))),
        "step": np.asarray(seed + 3, np.int32),
    }
    return np_tree, params_from_numpy(np_tree, device="cpu")


def _equal_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.reshape(-1).view(torch.uint8).tolist()
            == b.reshape(-1).view(torch.uint8).tolist())


def _files(d):
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_ckpt_roundtrip_and_single_write(tmp_path):
    m = Metrics()
    store = NezhaCheckpointStore(str(tmp_path), m, gc_threshold_bytes=1 << 60)
    tree = tiny_tree()
    store.save(10, tree)
    assert m.write_bytes["ckpt_valuelog"] == tree_bytes(tree)  # exactly once
    restored, step = store.restore(tree)
    assert step == 10
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert _equal_bits(a, b)
    store.close()


def test_ckpt_gc_compacts_and_keeps_latest(tmp_path):
    store = NezhaCheckpointStore(str(tmp_path), gc_threshold_bytes=1 << 60,
                                 keep=2)
    for s in range(1, 6):
        store.save(s, tiny_tree(seed=s))
    store.gc()
    assert sorted(store.manifests) == [4, 5]
    r4, _ = store.restore(tiny_tree(), step=4)
    for a, b in zip(tree_leaves(tiny_tree(seed=4)), tree_leaves(r4)):
        assert _equal_bits(a, b)
    # old vlogs physically removed
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".vlog")]) == 1
    store.close()


def test_ckpt_reload_from_disk(tmp_path):
    store = NezhaCheckpointStore(str(tmp_path))
    store.save(3, tiny_tree(seed=3))
    store.close()
    store2 = NezhaCheckpointStore(str(tmp_path))
    assert store2.latest_step() == 3
    r, _ = store2.restore(tiny_tree())
    assert _equal_bits(r["a"], tiny_tree(seed=3)["a"])
    store2.close()


def test_restore_without_checkpoint_raises(tmp_path):
    store = NezhaCheckpointStore(str(tmp_path))
    with pytest.raises(LookupError):
        store.restore(tiny_tree())
    store.close()


@pytest.mark.parametrize("with_coordinator", [False, True])
def test_crash_restore_bit_identical_losses(with_coordinator):
    """Crash after step 10 of 12 with a checkpoint every 4: the restore
    starts at 8 and the resumed losses equal the uninterrupted run's bit
    for bit.  With a coordinator the restore point comes from the Raft
    cluster (the manifest committed through consensus)."""
    cfg = get("smollm_135m", smoke=True)
    wd1, wd2 = tempfile.mkdtemp(), tempfile.mkdtemp()
    coords, runners = [], []

    def runner(wd, coord=None):
        if with_coordinator and coord is None:
            coord = Coordinator(wd)
            coords.append(coord)
        runners.append(TrainRunner(cfg, SHAPE, wd, seed=7, ckpt_every=4,
                                   coordinator=coord, device="cpu"))
        return runners[-1]

    try:
        r = runner(wd1)
        r.init_or_restore()
        ref = r.run(12)

        r2 = runner(wd2)
        r2.init_or_restore()
        with pytest.raises(RuntimeError, match="injected host failure"):
            r2.run(12, crash_at=10)
        # the host restarts; the control plane (when there is one) lives on
        r2.close()
        r3 = runner(wd2, r2.coord)
        start = r3.init_or_restore()
        assert start == 8
        if with_coordinator:
            assert r3.store.manifests and r3.coord.committed_steps(
                "ckpt") == [4, 8]
            assert r3.coord.committed_steps("step") == list(range(10))
        resumed = r3.run(12)
        assert len(ref) == 12 and ref[start:] == resumed
        if with_coordinator:
            assert r3.coord.committed_steps("ckpt") == [4, 8, 12]
    finally:
        for r in runners:
            r.close()
        for c in coords:
            c.destroy()
        shutil.rmtree(wd1, ignore_errors=True)
        shutil.rmtree(wd2, ignore_errors=True)


def test_straggler_detection(tmp_path):
    coord = Coordinator(str(tmp_path), n_controllers=3)
    try:
        t = 100.0
        for step in range(8):
            for h in (0, 1):
                coord.heartbeat(h, step, t)
            t += 1.0
        coord.heartbeat(0, 8, t)          # host 1 goes quiet
        coord.heartbeat(0, 9, t + 1)
        coord.heartbeat(0, 10, t + 2)
        assert coord.stragglers(now=t + 3.5, hosts=[0, 1]) == [1]
    finally:
        coord.destroy()


def test_restore_into_the_abstract_state_template(tmp_path):
    """The manifest names tensors, not devices: a train state saved from
    one runner restores into the meta-device template, dtype for dtype."""
    cfg = get("smollm_135m", smoke=True)
    state = make_init_fn(cfg, "cpu")(0)
    store = NezhaCheckpointStore(str(tmp_path / "ck"))
    store.save(1, state)
    host_tree, step = store.restore(abstract_state(cfg))
    assert step == 1
    for (n, a), (_, b) in zip(tree_paths(state), tree_paths(host_tree)):
        assert b.device.type == "cpu" and _equal_bits(a, b), n
    store.close()


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_pipeline_restart_safe_and_byte_equal_to_jax(host, n_hosts):
    cfg = get("smollm_135m", smoke=True)
    jshape = JaxShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    p1 = TokenPipeline(cfg, SHAPE, seed=3, host_id=host, n_hosts=n_hosts)
    p2 = TokenPipeline(cfg, SHAPE, seed=3, host_id=host, n_hosts=n_hosts,
                       start_step=5)
    jp = JaxPipeline(jax_get("smollm_135m", smoke=True), jshape, seed=3,
                     host_id=host, n_hosts=n_hosts)
    try:
        b5, b5b, j5 = (p.batch_for_step(5) for p in (p1, p2, jp))
        first = next(p2)
    finally:
        for p in (p1, p2, jp):
            p.close()
    assert not p1._thread.is_alive() and not p2._thread.is_alive()
    for k in ("tokens", "labels"):
        assert b5[k].shape == (4 // n_hosts, 32)
        assert b5[k].dtype == j5[k].dtype == np.int32
        assert b5[k].tobytes() == b5b[k].tobytes() == j5[k].tobytes()
        assert first[k].tobytes() == b5[k].tobytes()   # iteration starts there


def test_jax_checkpoint_restores_byte_equal_in_torch(tmp_path):
    np_tree, torch_tree = mixed_tree(1)
    js = JaxStore(str(tmp_path))
    js.save(7, np_tree)
    js.close()
    store = NezhaCheckpointStore(str(tmp_path))
    assert store.latest_step() == 7
    restored, step = store.restore(torch_tree)
    assert step == 7
    assert {str(t.dtype) for t in tree_leaves(restored)} == {
        "torch.bfloat16", "torch.float32", "torch.int32"}
    for (n, a), (_, b) in zip(tree_paths(torch_tree), tree_paths(restored)):
        assert _equal_bits(a, b), n
    store.close()


def test_torch_checkpoint_restores_byte_equal_in_jax(tmp_path):
    np_tree, torch_tree = mixed_tree(2)
    store = NezhaCheckpointStore(str(tmp_path))
    store.save(9, torch_tree)
    store.close()
    js = JaxStore(str(tmp_path))
    restored, step = js.restore(np_tree)
    assert step == 9
    for (a, b) in zip(jax.tree.leaves(np_tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    js.close()


def test_both_stores_write_byte_equal_files(tmp_path):
    """Three saves, a GC and one more save through each store: every file
    (value logs and manifests) is byte-equal between the two."""
    dirs = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        store = (JaxStore if pkg == "jax" else NezhaCheckpointStore)(
            str(d), gc_threshold_bytes=1 << 60, keep=2)
        for s in (1, 2, 3, 4):
            np_tree, torch_tree = mixed_tree(s)
            store.save(s, np_tree if pkg == "jax" else torch_tree)
            if s == 3:
                dirs[pkg + "_pre_gc"] = _files(d)
                store.gc()
        store.close()
        dirs[pkg] = _files(d)
    assert dirs["jax_pre_gc"] == dirs["torch_pre_gc"]
    assert sorted(dirs["jax"]) == sorted(dirs["torch"]) == [
        "ckpt_0001.vlog", "manifests/000000000002.json",
        "manifests/000000000003.json", "manifests/000000000004.json"]
    assert dirs["jax"] == dirs["torch"]


def test_jax_train_state_restores_in_the_port_runner():
    """A JAX TrainRunner's checkpoint (bf16 params, f32 moments, int32
    step) is where the port's runner starts, bit for bit."""
    from repro.runtime.coordinator import TrainRunner as JaxRunner
    jcfg = jax_get("smollm_135m", smoke=True)
    jshape = JaxShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    wd = tempfile.mkdtemp()
    try:
        jr = JaxRunner(jcfg, jshape, make_host_mesh(), wd, seed=5,
                       ckpt_every=2)
        jr.init_or_restore()
        jr.run(2)
        saved = jax.tree.map(np.asarray, jr.state)
        r = TrainRunner(get("smollm_135m", smoke=True), SHAPE, wd, seed=5,
                        ckpt_every=2, device="cpu")
        assert r.init_or_restore() == 2
        r.close()
        mine = dict(tree_paths(r.state))
        for n, a in tree_paths(saved):
            assert _equal_bits(mine[n], params_from_numpy(
                {"x": a}, device="cpu")["x"]), n
        assert mine["step"].dtype == torch.int32 and int(mine["step"]) == 2
    finally:
        shutil.rmtree(wd, ignore_errors=True)
