"""The port's sharded checkpoint against the JAX package's.

A counterpart of each class of ``tests/test_sharded_ckpt.py`` (format
round trip, fleet ownership, re-sharding restore, corruption fuzz,
manifest mirror, asynchronous save, the coordinated shared directory,
manager plumbing), one case a mechanism, parametrised where cases share
a body; every restore is bit for bit. Besides:

- a step directory written by the reference loads in the port, and one
  written by the port loads in the reference, bit for bit (bf16 and a
  pickled leaf included);
- ZeRO stage 1 (``group_sharded_parallel(..., "os")``, GPT tiny, AdamW)
  on a gloo world of 2 saves through the coordinator and restores onto 1
  rank, and a 1-rank run restores onto 2 (``tests/torch_dist_workers.py
  zero_ckpt``): the restored parameters and optimizer state equal the
  state gathered before the save bit for bit, and the next step's loss and
  state equal the unbroken run's bit for bit (every rank feeds the same
  batch, so the group's mean gradient is each rank's own exactly).
"""
import json
import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.distributed import sharded_checkpoint as jsc
from paddle_tpu.distributed.checkpoint import open_manager as jopen_manager
from paddle_tpu_torch import fault
from paddle_tpu_torch.distributed import checkpoint as dist_ckpt
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import sharded_checkpoint as sc
from paddle_tpu_torch.distributed.checkpoint import (CheckpointCorruptError,
                                                     CheckpointCoordinator,
                                                     detect_layout,
                                                     open_manager)
from paddle_tpu_torch.distributed.sharding import ShardedTensor
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.profiler import metrics as metrics_mod

import torch_dist_workers as workers


@pytest.fixture(autouse=True)
def _clean_injector():
    fault.reset()
    yield
    fault.reset()


@pytest.fixture()
def master():
    st = TCPStore("127.0.0.1", 0, is_master=True)
    yield st
    st.stop()


def _mgr(tmp_path, master=None, rank=0, world=1, **kw):
    """A sharded manager; with ``master``, one coordinated rank sharing
    ``tmp_path``."""
    coord = None
    if master is not None:
        store = TCPStore("127.0.0.1", master.port)
        coord = CheckpointCoordinator(store, rank, world, timeout=5.0,
                                      poll_interval=0.005)
    return open_manager(str(tmp_path), layout="sharded", coordinator=coord,
                        **kw)


def _state(seed=0.0):
    return {
        "net": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)
                + seed,
                "b": np.full(4, 2.0 + seed, np.float32),
                "h": torch.full((2, 3), 0.5 + seed, dtype=torch.bfloat16)},
        "slots": [np.zeros(3, np.float32), np.ones(3, np.float32) * seed],
        "cursor": {"epoch": 3, "step_in_epoch": int(seed), "done": False},
        "tag": "gen-" + str(seed),
        "shapes": (2, "a", None),
        "exotic": np.float32(1.25),  # not JSON-able: a pickled leaf
    }


def _same(a, b):
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _assert_state_equal(a, b):
    assert set(a) == set(b)
    for k in ("w", "b", "h"):
        assert _same(a["net"][k], b["net"][k]), k
    for x, y in zip(a["slots"], b["slots"]):
        assert _same(x, y)
    assert a["cursor"] == b["cursor"]
    assert a["tag"] == b["tag"]
    assert a["shapes"] == b["shapes"]
    assert float(a["exotic"]) == float(b["exotic"])


def _counter_total(name, **labels):
    m = metrics_mod.default_registry().get(name)
    if m is None:
        return 0.0
    return sum(v["value"] for v in m.snapshot()["values"]
               if all(v["labels"].get(k) == lv for k, lv in labels.items()))


def _hist_sum(name):
    m = metrics_mod.default_registry().get(name)
    if m is None:
        return 0.0
    return sum(v["sum"] for v in m.snapshot()["values"])


def _run_ranks(fn, world=2):
    res = {}
    ts = [threading.Thread(target=lambda r=r: res.update({r: fn(r)}))
          for r in range(world)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    return res


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------
class TestFormatRoundtrip:
    def test_roundtrip_manifest_and_layout(self, tmp_path):
        m = _mgr(tmp_path)
        st = _state(5.0)
        assert m.save(st, 4) is True
        got, step = m.load_latest()
        assert step == 4
        _assert_state_equal(got, st)
        sd = m.path_for(4)
        with open(os.path.join(sd, "manifest-r0.json")) as f:
            man = json.load(f)
        assert man["magic"] == sc.MANIFEST_MAGIC == jsc.MANIFEST_MAGIC
        assert man["world_size"] == 1 and man["rank"] == 0
        assert man["arrays"]["/net/w"] == {"shape": [3, 4],
                                           "dtype": "float32", "spec": None}
        assert man["arrays"]["/net/h"]["dtype"] == "bfloat16"
        for rec in man["chunks"]:
            with open(os.path.join(sd, rec["file"]), "rb") as f:
                data = f.read()
            assert len(data) == rec["bytes"]
            assert zlib.crc32(data) & 0xFFFFFFFF == rec["crc32"]
        assert sc.verify_step(sd, deep=True)[0] == "complete"
        # layouts: the directory detects as sharded, "auto" opens it so,
        # and the file backend's resume walks past step directories
        assert detect_layout(str(tmp_path)) == "sharded"
        assert open_manager(str(tmp_path)).layout == "sharded"
        assert dist_ckpt.latest_valid(str(tmp_path)) is None
        d2 = tmp_path / "plain"
        dist_ckpt.CheckpointManager(str(d2)).save({"w": np.ones(2)}, 1)
        assert open_manager(str(d2)).layout == "file"

    def test_mixed_dir_resolves_to_newest_step_layout(self, tmp_path):
        dist_ckpt.CheckpointManager(str(tmp_path)).save(
            {"w": np.ones(2, np.float32)}, 10)
        _mgr(tmp_path).save(_state(), 20)
        assert detect_layout(str(tmp_path)) == "sharded"
        assert open_manager(str(tmp_path)).load_latest()[1] == 20
        d2 = tmp_path / "rev"
        open_manager(str(d2), layout="sharded").save(_state(), 3)
        dist_ckpt.CheckpointManager(str(d2)).save(
            {"w": np.ones(2, np.float32)}, 7)
        assert detect_layout(str(d2)) == "file"
        assert open_manager(str(d2)).load_latest()[1] == 7

    def test_reference_step_loads_in_the_port(self, tmp_path):
        mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
        st = {"w": jax.device_put(
            jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
            NamedSharding(mesh, P("x"))),
            "h": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
            "i": np.arange(5, dtype=np.int32), "exotic": np.float32(2.5),
            "meta": {"t": 3, "name": "x"}}
        jopen_manager(str(tmp_path), layout="sharded").save(st, 1)
        got, step = open_manager(str(tmp_path)).load_latest()
        assert step == 1
        assert _same(got["w"], torch.arange(64.0).reshape(8, 8))
        assert got["h"].dtype == torch.bfloat16
        assert torch.equal(got["h"].view(torch.int16), torch.from_numpy(
            np.array(st["h"]).view(np.int16)))
        assert _same(got["i"], st["i"])
        assert float(got["exotic"]) == 2.5 and got["meta"] == st["meta"]

    def test_port_step_loads_in_the_reference(self, tmp_path):
        st = _state(3.0)
        _mgr(tmp_path).save(st, 2)
        got = jsc.load_step(os.path.join(str(tmp_path), "ckpt_2"))
        np.testing.assert_array_equal(np.asarray(got["net"]["w"]),
                                      st["net"]["w"].numpy())
        h = np.asarray(got["net"]["h"])
        assert str(h.dtype) == "bfloat16"
        np.testing.assert_array_equal(
            h.view(np.int16), st["net"]["h"].view(torch.int16).numpy())
        assert float(got["exotic"]) == 1.25
        assert got["cursor"] == st["cursor"] and got["tag"] == st["tag"]

    def test_refuses_a_pickle_naming_jax(self, tmp_path):
        jopen_manager(str(tmp_path), layout="sharded").save(
            {"w": np.ones(2, np.float32),
             "obj": jax.sharding.PartitionSpec("x")}, 1)
        with pytest.raises(CheckpointCorruptError):
            sc.load_step(os.path.join(str(tmp_path), "ckpt_1"))


# ---------------------------------------------------------------------------
# ownership across ranks
# ---------------------------------------------------------------------------
class TestFleetOwnership:
    def test_each_array_written_once_and_pieces_by_their_rank(
            self, tmp_path, master):
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        w = torch.arange(16.0).reshape(4, 4)
        states = [dict(_state(), piece=ShardedTensor(
            (4, 4), [[2 * r, 2 * r + 2], [0, 4]], w[2 * r:2 * r + 2],
            ("sharding", None))) for r in range(2)]
        res = _run_ranks(lambda r: ms[r].save(states[r], 1))
        assert res == {0: True, 1: True}
        scan = sc.scan_step(ms[0].path_for(1))
        assert sorted(scan.manifests) == [0, 1]
        seen = {}
        for rank, man in scan.manifests.items():
            assert man["arrays"]["/piece"]["spec"] == ["sharding", None]
            for rec in man["chunks"]:
                if rec["path"] == "/piece":
                    assert rec["index"][0] == [2 * rank, 2 * rank + 2]
                    continue
                assert rec["path"] not in seen, "array written twice"
                seen[rec["path"]] = rank
        for path, rank in seen.items():
            assert rank == sc.owner_rank(path, 2) == jsc.owner_rank(path, 2)
        assert sc.verify_step(ms[0].path_for(1), deep=True)[0] == "complete"
        # one rank of a new world of one reads both ranks' chunks
        got, step = open_manager(str(tmp_path)).load_latest()
        assert step == 1 and _same(got["piece"], w)
        _assert_state_equal({k: v for k, v in got.items() if k != "piece"},
                            _state())

    def test_scale_up_restore_from_shared_dir(self, tmp_path, master):
        _mgr(tmp_path).save(_state(9.0), 5)
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        res = _run_ranks(lambda r: ms[r].load_latest())
        for r in range(2):
            got, step = res[r]
            assert step == 5
            _assert_state_equal(got, _state(9.0))


# ---------------------------------------------------------------------------
# re-sharding onto a group
# ---------------------------------------------------------------------------
class _RankGroup(C.Group):
    """A group seen from rank ``r`` (no process group: the restore reads
    only the group's shape and this rank's place in it)."""

    def __init__(self, n, r, axis):
        super().__init__(None, (axis,), ranks=list(range(n)), pg=None,
                         backend="gloo")
        self._r = r

    @property
    def rank(self):
        return self._r


class TestReshardingRestore:
    def _save_sharded(self, tmp_path, n_dev):
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("sharding",))
        w = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                           NamedSharding(mesh, P("sharding")))
        jopen_manager(str(tmp_path), layout="sharded").save(
            {"w": w, "b": np.ones(3, np.float32)}, 1)
        return np.arange(64, dtype=np.float32).reshape(8, 8)

    @pytest.mark.parametrize("saved,target", [(4, 2), (2, 4)])
    def test_restore_onto_another_world(self, tmp_path, saved, target):
        want = self._save_sharded(tmp_path, saved)
        for r in range(target):
            got, _ = open_manager(str(tmp_path),
                                  mesh=_RankGroup(target, r,
                                                  "sharding")).load_latest()
            k = 8 // target
            assert isinstance(got["w"], ShardedTensor)
            assert got["w"].box == [[r * k, (r + 1) * k], [0, 8]]
            assert got["w"].spec == ("sharding", None)
            assert _same(got["w"].local, want[r * k:(r + 1) * k])
            assert _same(got["b"], np.ones(3, np.float32))

    def test_sharding_axis_cuts_where_zero_holds_it(self, tmp_path):
        """A [6, 12] array over 4 devices is cut along dimension 1 (6 does
        not divide by 4); over 2 ranks ZeRO's rule cuts dimension 0, so the
        restore reads that box from the saved column chunks."""
        from paddle_tpu_torch.distributed.sharding import ZeroLayout
        mesh = Mesh(np.array(jax.devices()[:4]), ("sharding",))
        want = np.arange(72, dtype=np.float32).reshape(6, 12)
        jopen_manager(str(tmp_path), layout="sharded").save(
            {"w": jax.device_put(want, NamedSharding(
                mesh, P(None, "sharding")))}, 1)
        for r in range(2):
            group = _RankGroup(2, r, "sharding")
            got, _ = open_manager(str(tmp_path), mesh=group).load_latest()
            layout = ZeroLayout([("w", (6, 12), torch.float32, "cpu")],
                                group)
            assert got["w"].box == layout.box("w") == [[3 * r, 3 * r + 3],
                                                       [0, 12]]
            assert got["w"].spec == ("sharding", None)
            assert _same(layout.local_of(got["w"], "w"),
                         want[3 * r:3 * r + 3])

    def test_missing_axis_replicates_loudly(self, tmp_path):
        want = self._save_sharded(tmp_path, 4)
        with pytest.warns(UserWarning, match="keeping the array replicated"):
            got, _ = open_manager(
                str(tmp_path), mesh=_RankGroup(2, 1, "model")).load_latest()
        assert _same(got["w"], want)
        assert _counter_total("checkpoint_reshard_fallback_total",
                              path="/w") >= 1

    def test_file_layout_restores_onto_a_group(self, tmp_path):
        from paddle_tpu.distributed import checkpoint as jckpt
        mesh = Mesh(np.array(jax.devices()[:2]), ("sharding",))
        w = jax.device_put(jnp.arange(8, dtype=jnp.float32).reshape(4, 2),
                           NamedSharding(mesh, P("sharding")))
        jckpt.save({"w": w}, str(tmp_path / "ckpt_1"))
        got = dist_ckpt.load(str(tmp_path / "ckpt_1"),
                             mesh=_RankGroup(2, 1, "sharding"))
        assert got["w"].box == [[2, 4], [0, 2]]
        assert _same(got["w"].local, np.arange(4, 8, dtype=np.float32)
                     .reshape(2, 2))

    def test_reshard_fault_site_is_armed(self, tmp_path):
        from paddle_tpu_torch.fault.inject import KNOWN_SITES
        assert {"ckpt.reshard", "ckpt.chunk_write"} <= set(KNOWN_SITES)
        m = _mgr(tmp_path)
        m.save(_state(), 1)
        fault.configure("ckpt.reshard", times=1)
        with pytest.raises(fault.InjectedFault):
            sc.load_step(m.path_for(1))
        assert fault.default_injector().fired("ckpt.reshard") == 1
        assert m.load_latest()[1] == 1


# ---------------------------------------------------------------------------
# corruption fuzz
# ---------------------------------------------------------------------------
def _chunk_of(m, step, path="/net/w"):
    sd = m.path_for(step)
    with open(os.path.join(sd, "manifest-r0.json")) as f:
        man = json.load(f)
    rec = next(c for c in man["chunks"] if c["path"] == path)
    return os.path.join(sd, rec["file"])


def _bitflip(m):
    cf = _chunk_of(m, 3)
    data = bytearray(open(cf, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(cf, "wb").write(bytes(data))


def _truncate(m):
    cf = _chunk_of(m, 3)
    data = open(cf, "rb").read()
    open(cf, "wb").write(data[:len(data) // 2])


def _delete_chunk(m):
    os.remove(_chunk_of(m, 3))


def _garble_manifest(m):
    open(os.path.join(m.path_for(3), "manifest-r0.json"), "wb").write(
        b"\x00garbage{{{")


def _bitflip_pickle(m):
    mf = os.path.join(m.path_for(3), "manifest-r0.json")
    man = json.load(open(mf))
    node = man["tree"]["exotic"]
    node["__ptpickle__"] = "AAAA" + node["__ptpickle__"][4:]
    json.dump(man, open(mf, "w"))


class TestCorruptionFuzz:
    @pytest.mark.parametrize("damage", [_bitflip, _truncate, _delete_chunk,
                                        _garble_manifest, _bitflip_pickle])
    def test_damaged_newest_step_falls_back(self, tmp_path, damage):
        m = _mgr(tmp_path, keep_last_n=5)
        for s in (1, 2, 3):
            m.save(_state(float(s)), s)
        damage(m)
        assert sc.verify_step(m.path_for(3), deep=True)[0] != "complete" \
            or damage is _bitflip_pickle
        if damage is _bitflip_pickle:  # corrupt, never a raw traceback
            with pytest.raises(CheckpointCorruptError):
                sc.load_step(m.path_for(3))
        with pytest.warns(UserWarning, match="skipping corrupt"):
            got, step = m.load_latest()
        assert step == 2
        _assert_state_equal(got, _state(2.0))

    def test_deleted_manifest_skips_silently(self, tmp_path):
        m = _mgr(tmp_path)
        for s in (1, 2):
            m.save(_state(float(s)), s)
        os.remove(os.path.join(m.path_for(2), "manifest-r0.json"))
        assert m.load_latest()[1] == 1
        os.remove(_chunk_of(m, 1))
        with pytest.warns(UserWarning, match="skipping corrupt"):
            assert m.load_latest() is None

    def test_lost_rank_partial_or_corrupt(self, tmp_path, master):
        """Losing a rank that wrote no chunk leaves the step partial (and
        restorable); losing one that did, with its mirror, corrupt."""
        state, i = {}, 0
        while len(state) < 3:  # keys all owned by rank 0 under world 2
            if sc.owner_rank(f"/k{i}", 2) == 0:
                state[f"k{i}"] = np.full(4, float(i), np.float32)
            i += 1
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        _run_ranks(lambda r: ms[r].save(state, 1))
        sd = ms[0].path_for(1)
        os.remove(os.path.join(sd, "manifest-r1.json"))
        os.remove(os.path.join(sd, "manifest-r1.json.mirror"))
        assert sc.verify_step(sd, deep=True)[0] == "partial"
        got, _ = open_manager(str(tmp_path)).load_latest()
        for k, v in state.items():
            assert _same(got[k], v)
        ms = [_mgr(tmp_path / "b", master, r, 2) for r in range(2)]
        _run_ranks(lambda r: ms[r].save(_state(), 1))
        sd = ms[0].path_for(1)
        assert {sc.owner_rank(p, 2) for p in
                sc.scan_step(sd).manifests[0]["arrays"]} == {0, 1}
        os.remove(os.path.join(sd, "manifest-r1.json"))
        os.remove(os.path.join(sd, "manifest-r1.json.mirror"))
        assert sc.verify_step(sd)[0] == "corrupt"


# ---------------------------------------------------------------------------
# manifest mirror
# ---------------------------------------------------------------------------
class TestManifestMirrorFuzz:
    def _two_rank_save(self, tmp_path, master):
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        _run_ranks(lambda r: ms[r].save(_state(), 1))
        return ms, ms[0].path_for(1)

    def test_every_rank_manifest_gets_a_peer_mirror(self, tmp_path, master):
        ms, sd = self._two_rank_save(tmp_path, master)
        for r in range(2):
            with open(os.path.join(sd, f"manifest-r{r}.json"), "rb") as a, \
                    open(os.path.join(sd, f"manifest-r{r}.json.mirror"),
                         "rb") as b:
                assert a.read() == b.read()
        scan = sc.scan_step(sd)
        assert scan.mirrored == [] and set(scan.manifests) == {0, 1}
        # a world of one writes none
        m = _mgr(tmp_path / "one")
        m.save(_state(), 1)
        m.save(_state(1.0), 2)
        assert not [fn for s in (1, 2) for fn in os.listdir(m.path_for(s))
                    if fn.endswith(".mirror")]

    @pytest.mark.parametrize("how", ["delete", "garble"])
    def test_lost_manifest_recovers_partial_via_mirror(self, tmp_path,
                                                       master, how):
        ms, sd = self._two_rank_save(tmp_path, master)
        victim = os.path.join(sd, "manifest-r1.json")
        if how == "delete":
            os.remove(victim)
        else:
            open(victim, "wb").write(b"\x00garbage{{{")
        scan = sc.scan_step(sd)
        assert scan.mirrored == [1]
        status, detail = sc.verify_step(sd, deep=True)
        assert status == "partial" and "peer-mirrored" in detail, detail
        got, step = open_manager(str(tmp_path)).load_latest()
        _assert_state_equal(got, _state())

    def test_corrupt_mirror_is_harmless_and_sweep_takes_own_tmp(
            self, tmp_path, master):
        ms, sd = self._two_rank_save(tmp_path, master)
        mirror = os.path.join(sd, "manifest-r1.json.mirror")
        open(mirror, "wb").write(b"\xff\xfe not json")
        scan = sc.scan_step(sd)
        assert scan.mirrored == [] and scan.bad_manifests == []
        assert sc.verify_step(sd, deep=True)[0] == "complete"
        torn = os.path.join(sd, "manifest-r1.json.mirror.tmp.r0")
        peer = os.path.join(sd, "manifest-r0.json.mirror.tmp.r1")
        for p in (torn, peer):
            open(p, "wb").write(b"half")
        ms[0]._sweep_orphans()
        assert not os.path.exists(torn) and os.path.exists(peer)


# ---------------------------------------------------------------------------
# asynchronous save
# ---------------------------------------------------------------------------
class TestAsyncSave:
    def test_save_is_off_the_critical_path_with_backpressure(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0.4")
        fault.configure("ckpt.chunk_write", times=2, kind="delay")
        async_sum0 = _hist_sum("checkpoint_async_seconds")
        bytes0 = _counter_total("checkpoint_async_bytes")
        m = _mgr(tmp_path, async_save=True)
        st = {"w": torch.randn(64, 64, generator=torch.Generator()
                               .manual_seed(0))}
        t0 = time.perf_counter()
        assert m.save(st, 1) is True
        assert time.perf_counter() - t0 < 0.2, "save() waited for the write"
        assert m._save_in_flight, "the writer's save is not in flight"
        t0 = time.perf_counter()
        m.save(st, 2)  # waits for save 1's writer
        assert time.perf_counter() - t0 >= 0.15, "no backpressure"
        m._writer.drain()
        assert not m._save_in_flight
        assert _hist_sum("checkpoint_async_seconds") - async_sum0 >= 0.8
        assert _counter_total("checkpoint_async_bytes") > bytes0
        got, step = m.load_latest()
        assert step == 2 and _same(got["w"], st["w"])

    def test_background_failure_surfaces_on_drain(self, tmp_path):
        fault.configure("ckpt.chunk_write", times=1, kind="oserror")
        m = _mgr(tmp_path, async_save=True)
        m.save({"w": np.zeros(4, np.float32)}, 1)
        with pytest.raises(fault.InjectedIOError):
            m._writer.drain()
        assert m.load_latest() is None

    def test_snapshot_is_a_copy(self, tmp_path, monkeypatch):
        """The port's training updates its tensors in place: the save
        writes the values of the moment it was called."""
        monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0.2")
        fault.configure("ckpt.chunk_write", times=1, kind="delay")
        m = _mgr(tmp_path, async_save=True)
        w = torch.zeros(8)
        m.save({"w": w}, 1)
        w.add_(1.0)
        m.drain()
        assert _same(m.load_latest()[0]["w"], torch.zeros(8))


# ---------------------------------------------------------------------------
# the coordinated shared directory
# ---------------------------------------------------------------------------
class TestCoordinatedSharedDir:
    def test_two_ranks_commit_one_directory(self, tmp_path, master):
        commits0 = _counter_total("ckpt_barrier_commits_total")
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        assert _run_ranks(lambda r: ms[r].save(_state(), 1)) == \
            {0: True, 1: True}
        assert _counter_total("ckpt_barrier_commits_total") >= commits0 + 2
        sd = ms[0].path_for(1)
        assert sc.verify_step(sd, deep=True)[0] == "complete"
        assert not any(f.endswith(".tmp.prep") for f in os.listdir(sd))

    def test_missing_peer_aborts_then_recommits(self, tmp_path, master):
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        ms[0].coordinator.timeout = 0.5
        with pytest.warns(UserWarning, match="aborted"):
            assert ms[0].save(_state(), 2) is False
        sd = ms[0].path_for(2)
        assert not os.path.isdir(sd) or not any(
            sc._parse_manifest_name(f) is not None for f in os.listdir(sd))
        ms[1].coordinator.abort_next_round(2)  # the peer stays lockstep
        assert _run_ranks(lambda r: ms[r].save(_state(), 2)) == \
            {0: True, 1: True}
        assert sc.verify_step(ms[0].path_for(2))[0] == "complete"

    def test_writer_death_aborts_promptly_for_peer(self, tmp_path, master):
        ms = [_mgr(tmp_path, master, r, 2) for r in range(2)]
        for m in ms:
            m.coordinator.timeout = 30.0
        fault.configure("ckpt.chunk_write", times=1)

        def run(r):
            try:
                return ms[r].save(_state(), 1)
            except fault.InjectedFault:
                return "died"
        t0 = time.perf_counter()
        with pytest.warns(UserWarning, match="aborted"):
            res = _run_ranks(run)
        assert sorted(map(str, res.values())) == ["False", "died"], res
        assert time.perf_counter() - t0 < 10
        assert fault.default_injector().fired("ckpt.chunk_write") == 1

    def test_save_in_flight_during_sync_coordinated_save(self, tmp_path,
                                                         master):
        import warnings as _w
        m0 = _mgr(tmp_path, master, 0, 2)
        m0.coordinator.timeout = 1.5
        sampled = []

        def run():
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                m0.save(_state(), 1)
        t = threading.Thread(target=run)
        t.start()
        time.sleep(0.4)
        sampled.append(m0._save_in_flight)
        t.join(timeout=30)
        assert sampled == [True] and not m0._save_in_flight


# ---------------------------------------------------------------------------
# manager plumbing
# ---------------------------------------------------------------------------
class TestManagerPlumbing:
    def test_gc_steps_and_latest_valid_path(self, tmp_path):
        m = _mgr(tmp_path, keep_last_n=2)
        for s in range(1, 6):
            m.save(_state(float(s)), s)
        assert m.steps() == [5, 4]
        assert m.latest_valid_path() == m.path_for(5)
        assert sc.newest_committed_step(str(tmp_path)) == (5, m.path_for(5))

    def test_orphan_sweep_takes_own_files_only(self, tmp_path):
        m = _mgr(tmp_path)
        m.save(_state(), 1)
        sd = m.path_for(1)
        mine = ["manifest-r0.json.tmp.prep", "r0-9999.g0a9.chunk"]
        peers = ["manifest-r1.json.tmp.prep", "r1-0000.g0a1.chunk"]
        for fn in mine + peers:
            open(os.path.join(sd, fn), "wb").write(b"zz")
        m2 = _mgr(tmp_path)  # construction sweeps
        left = os.listdir(sd)
        assert not set(mine) & set(left) and set(peers) <= set(left)
        assert m2.load_latest()[1] == 1

    def test_garbled_rank_env_raises_named_error(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINER_ID", "not-a-rank")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        with pytest.raises(ValueError, match="PADDLE_TRAINER_ID"):
            open_manager(str(tmp_path), layout="sharded")

    def test_newest_generation_wins_despite_clock_skew(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_ELASTIC_RESTART_NUM", "1")
        m = _mgr(tmp_path)
        m.save({"w": np.ones(4, np.float32)}, 1)
        sd = m.path_for(1)
        with open(os.path.join(sd, "manifest-r0.json")) as f:
            man = json.load(f)
        stale = dict(man, world_size=2, rank=1, generation=0,
                     wall_time=man["wall_time"] + 1e6, chunks=[])
        with open(os.path.join(sd, "manifest-r1.json"), "w") as f:
            json.dump(stale, f)
        assert sc.scan_step(sd).world_size == 1
        assert open_manager(str(tmp_path)).load_latest()[1] == 1

    def test_publish_sync_drains_writer_first(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0.25")
        fault.configure("ckpt.chunk_write", times=1, kind="delay")
        m = _mgr(tmp_path, async_save=True)
        m.save(_state(1.0), 1)
        assert m._publish_sync(_state(2.0), 2) is True
        assert m.steps() == [2, 1]
        for s in (1, 2):
            assert sc.verify_step(m.path_for(s), deep=True)[0] == "complete"

    def test_fit_resume_roundtrip_and_drain(self, tmp_path, monkeypatch):
        """ModelCheckpoint(layout="sharded") and fit(resume=) over it: the
        resumed run equals the uninterrupted one bit for bit; fit drains
        the asynchronous writer before it returns."""
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.hapi import Model
        from paddle_tpu_torch.hapi.callbacks import FaultTolerantCheckpoint
        from paddle_tpu_torch.io import Dataset

        class DS(Dataset):
            def __len__(self):
                return 8

            def __getitem__(self, i):
                rng = np.random.RandomState(100 + i)
                return (rng.randn(4).astype(np.float32),
                        rng.randn(2).astype(np.float32))

        def build():
            torch.manual_seed(7)
            net = torch.nn.Linear(4, 2)
            mdl = Model(net)
            mdl.prepare(optimizer.Adam(learning_rate=1e-2,
                                       parameters=net.parameters()),
                        loss=torch.nn.functional.mse_loss)
            return mdl

        d = str(tmp_path / "ck")
        m1 = build()
        cb = FaultTolerantCheckpoint(d, save_freq_steps=1, layout="sharded",
                                     preemption_save=False)
        m1.fit(DS(), batch_size=2, epochs=1, shuffle=False, verbose=0,
               callbacks=[cb], num_iters=2)
        assert detect_layout(d) == "sharded"
        m2 = build()
        cb2 = FaultTolerantCheckpoint(d, save_freq_steps=1,
                                      preemption_save=False)
        assert cb2.manager.layout == "sharded"
        m2.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
               callbacks=[cb2], resume=d)
        ref = build()
        ref.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0)
        for mm in (m2, ref):
            mm._sync_from_train_step()
        for k, v in ref.network.state_dict().items():
            assert torch.equal(m2.network.state_dict()[k], v), k
        # the asynchronous writer is drained when fit returns
        monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0.05")
        fault.configure("ckpt.chunk_write", times=999, kind="delay")
        cb3 = FaultTolerantCheckpoint(str(tmp_path / "a"), layout="sharded",
                                      async_save=True, preemption_save=False)
        build().fit(DS(), batch_size=2, epochs=1, shuffle=False, verbose=0,
                    callbacks=[cb3])
        assert not cb3.manager._writer.busy()
        path = cb3.manager.latest_valid_path()
        assert sc.verify_step(path, deep=True)[0] == "complete"


# ---------------------------------------------------------------------------
# ZeRO stage 1 across world sizes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """The worlds 2 (save), 1 (restore, then save), 2 (restore)."""
    import test_torch_sharding
    d = tmp_path_factory.mktemp("zero_ckpt")
    np.savez(d / "inputs.npz", **test_torch_sharding._inputs())
    return [workers.run_world("zero_ckpt", n, d, timeout=180)
            for n in (2, 1, 2)]


def _equal_state(a, b, err):
    assert set(a["params"]) == set(b["params"]), err
    for k, v in a["params"].items():
        assert np.array_equal(v, b["params"][k]), (err, k)
    assert set(a["opt"]) == set(b["opt"]), err
    for k, v in a["opt"].items():
        assert np.array_equal(np.asarray(v), np.asarray(b["opt"][k])), \
            (err, k)


@pytest.mark.parametrize("case", ["2 to 1", "1 to 2"])
def test_zero_stage1_restores_onto_another_world(zero_runs, case):
    two, one, two_again = zero_runs
    if case == "2 to 1":
        saved, restored = [r["save"] for r in two], [one[0]["restore"]]
        assert all(s["committed"] for s in saved)
        files = saved[0]["files"]
        assert {"manifest-r0.json", "manifest-r1.json"} <= set(files)
        assert any(f.startswith("r1-") for f in files)
    else:
        saved, restored = [one[0]["save"]], [r["restore"] for r in two_again]
    for s in saved[1:]:
        _equal_state(s["saved"], saved[0]["saved"], case)
    for r in restored:
        assert r["step"] == 2
        _equal_state(r["restored"], saved[0]["saved"], case + " restored")
        assert r["next_loss"] == saved[0]["next_loss"], case
        _equal_state(r["after"], saved[0]["after"], case + " next step")
