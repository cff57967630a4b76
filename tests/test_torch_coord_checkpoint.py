"""The port's coordinated checkpoint (two-phase commit, abort paths,
resume negotiation, the store-key GC and the abort-exit contract) held to
the reference's own cases (``tests/test_coord_checkpoint.py``), and the
two packages' coordinators in one round.

"Hosts" are threads sharing one in-process ``TCPStore`` master (torch's
store, the one ``init_parallel_env`` rendezvouses on), each with its own
client connection and checkpoint directory. Outcomes are exact (commit or
abort, which files exist, which step resumes); the restored arrays are
compared bit for bit.
"""
import os
import threading
import time
import warnings

import numpy as np
import pytest

from paddle_tpu_torch import fault
from paddle_tpu_torch.distributed import checkpoint as dist_ckpt
from paddle_tpu_torch.distributed.checkpoint import (CheckpointCoordinator,
                                                     CheckpointManager,
                                                     coordinator_from_env)
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.profiler import metrics as metrics_mod


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


def _state(seed=0):
    return {"w": np.arange(4, dtype=np.float32) + seed}


def _manager(master, rank, tmp_path, world=2, timeout=5.0, **kw):
    """One simulated host: own store client + own checkpoint dir."""
    store = TCPStore("127.0.0.1", master.port)
    coord = CheckpointCoordinator(store, rank, world, timeout=timeout,
                                  poll_interval=0.005, **kw)
    d = str(tmp_path / f"host{rank}")
    os.makedirs(d, exist_ok=True)
    return CheckpointManager(d, coordinator=coord)


def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "barrier thread wedged"


def _counter_total(name, **labels):
    m = metrics_mod.default_registry().get(name)
    if m is None:
        return 0.0
    return sum(v["value"] for v in m.snapshot()["values"]
               if all(v["labels"].get(k) == lv for k, lv in labels.items()))


class TestCoordinatedCommit:
    def test_both_hosts_commit_step(self, master, tmp_path):
        commits0 = _counter_total("ckpt_barrier_commits_total")
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.save(_state(), 1))),
            threading.Thread(target=lambda: res.update(b=m1.save(_state(), 1))),
        ])
        assert res == {"a": True, "b": True}
        for m in (m0, m1):
            newest = dist_ckpt.latest_valid(m.dirname)
            assert newest is not None and newest.endswith("ckpt_1")
            ok, reason = dist_ckpt.verify(newest)
            assert ok, reason
            # no leftover prepare tmp after a commit
            assert not any(".tmp." in f for f in os.listdir(m.dirname))
        assert _counter_total("ckpt_barrier_commits_total") >= commits0 + 2

    def test_single_host_has_no_barrier(self, tmp_path):
        m = CheckpointManager(str(tmp_path))  # world_size==1: plain save
        assert m.coordinator is None
        assert m.save(_state(), 1) is True
        assert dist_ckpt.latest_valid(str(tmp_path)) is not None

    def test_coordinated_manager_keeps_at_least_two(self, master, tmp_path):
        """keep_last_n=1 + coordinator is a resume wedge waiting to happen:
        after a two-generals crash the fleet agrees on N-1, which this
        host's GC already deleted. Coordinated managers floor it at 2."""
        m = _manager(master, 0, tmp_path)
        m.keep_last_n = 1  # what __init__ must have prevented
        m2 = CheckpointManager(str(tmp_path / "h"), keep_last_n=1,
                               coordinator=m.coordinator)
        assert m2.keep_last_n == 2
        plain = CheckpointManager(str(tmp_path / "p"), keep_last_n=1)
        assert plain.keep_last_n == 1  # single-host: no skew, no floor

    def test_world_size_one_coordinator_rejected(self, master):
        store = TCPStore("127.0.0.1", master.port)
        with pytest.raises(ValueError, match="world_size"):
            CheckpointCoordinator(store, 0, 1)

    def test_missing_peer_aborts_without_final_file(self, master, tmp_path):
        aborts0 = _counter_total("ckpt_barrier_aborts_total",
                                 reason="timeout")
        m0 = _manager(master, 0, tmp_path, timeout=0.5)
        with pytest.warns(UserWarning, match="aborted"):
            assert m0.save(_state(), 7) is False  # peer never arrives
        assert os.listdir(m0.dirname) == []  # tmp GC'd, nothing published
        assert _counter_total("ckpt_barrier_aborts_total",
                              reason="timeout") >= aborts0 + 1

    def test_commit_fault_aborts_fleet_wide(self, master, tmp_path):
        """The e2e's kill-between-prepare-and-commit, in-process: host 0
        faults at the ckpt.commit site (never votes), so host 1 times out
        and aborts — NO host publishes a final file for the step."""
        fault.configure("ckpt.commit", times=1)
        m0 = _manager(master, 0, tmp_path, timeout=2.0)
        m1 = _manager(master, 1, tmp_path, timeout=1.0)
        res = {}

        def host0():
            try:
                m0.save(_state(), 3)
            except fault.InjectedFault:
                res["a"] = "died"

        def host1():
            # the single armed injection must go to host 0: don't enter the
            # commit phase (and race for it) until host 0 has consumed it
            deadline = time.time() + 30
            while (fault.default_injector().fired("ckpt.commit") < 1
                   and time.time() < deadline):
                time.sleep(0.005)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res["b"] = m1.save(_state(), 3)

        _join_all([threading.Thread(target=host0),
                   threading.Thread(target=host1)])
        assert res == {"a": "died", "b": False}
        for m in (m0, m1):
            assert dist_ckpt.latest_valid(m.dirname) is None
            assert not os.path.exists(m.path_for(3))
        # the faulted host flagged the abort before dying: peers observe
        # it (or time out) instead of hanging, and both paths are metered
        assert fault.default_injector().fired("ckpt.commit") == 1
        assert _counter_total("ckpt_barrier_aborts_total") >= 1

    def test_reused_step_gets_fresh_barrier(self, master, tmp_path):
        """A step number committed in an earlier round (epoch-end save,
        then SIGTERM preemption save before the next step advances) must
        run a FRESH barrier — not insta-commit on the previous round's
        stale prep votes while a peer's prepare never happened."""
        m0 = _manager(master, 0, tmp_path, timeout=1.0)
        m1 = _manager(master, 1, tmp_path, timeout=1.0)
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.save(_state(), 1))),
            threading.Thread(target=lambda: res.update(b=m1.save(_state(), 1))),
        ])
        assert res == {"a": True, "b": True}
        # host 0 re-saves step 1 alone: peer never prepares, so the round
        # must time out and abort (stale round-0 votes must not satisfy it)
        with pytest.warns(UserWarning, match="aborted"):
            assert m0.save(_state(seed=9), 1) is False
        # the round-0 final file survives untouched
        newest = dist_ckpt.latest_valid(m0.dirname)
        assert newest is not None and newest.endswith("ckpt_1")
        ok, reason = dist_ckpt.verify(newest)
        assert ok, reason

    def test_aborted_step_number_can_recommit(self, master, tmp_path):
        """A step number whose round aborted must be retryable: the next
        round's barrier must not observe the previous round's abort flag
        (a preemption save re-using an aborted step would otherwise be
        silently dropped fleet-wide)."""
        m0 = _manager(master, 0, tmp_path, timeout=0.8)
        m1 = _manager(master, 1, tmp_path, timeout=0.8)
        # each host burns round 0 with a solo abort on DISJOINT steps
        # (lockstep: same number of rounds per host, like the real protocol
        # where an abort is observed by the whole fleet) — host 0's abort
        # flags step 7
        def solo(m, step):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert m.save(_state(), step) is False
        _join_all([threading.Thread(target=solo, args=(m0, 7)),
                   threading.Thread(target=solo, args=(m1, 6))])
        # round 1: the fleet re-commits step 7 — the round-0 abort flag
        # must not poison it
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.save(_state(), 7))),
            threading.Thread(target=lambda: res.update(b=m1.save(_state(), 7))),
        ])
        assert res == {"a": True, "b": True}
        for m in (m0, m1):
            assert os.path.exists(m.path_for(7))

    def test_prepare_failure_aborts_promptly_and_keeps_rounds(
            self, master, tmp_path, monkeypatch):
        """A prepare-phase failure (disk full, SIGTERM during the tmp
        write) must poison the round: the peer aborts promptly instead of
        burning the barrier timeout, and the failed host's round counter
        stays lockstep so its NEXT save still works."""
        m0 = _manager(master, 0, tmp_path, timeout=30.0)
        m1 = _manager(master, 1, tmp_path, timeout=30.0)
        orig = dist_ckpt._encode

        def failing(blob):
            if blob["state"].get("boom"):
                raise RuntimeError("disk full")
            return orig(blob)
        monkeypatch.setattr(dist_ckpt, "_encode", failing)
        res = {}

        def host0():
            try:
                m0.save({"boom": True, "w": np.zeros(2)}, 1)
            except RuntimeError:
                res["a"] = "failed"

        def host1():
            t0 = time.time()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res["b"] = m1.save(_state(), 1)
            res["b_secs"] = time.time() - t0
        _join_all([threading.Thread(target=host0),
                   threading.Thread(target=host1)])
        assert res["a"] == "failed" and res["b"] is False
        assert res["b_secs"] < 15  # prompt peer_abort, not the 30s timeout
        # round counters stayed lockstep: the next fleet save commits
        res2 = {}
        _join_all([
            threading.Thread(target=lambda: res2.update(a=m0.save(_state(), 2))),
            threading.Thread(target=lambda: res2.update(b=m1.save(_state(), 2))),
        ])
        assert res2 == {"a": True, "b": True}

    def test_ckpt_commit_armable_via_env_spec(self, master, tmp_path,
                                              monkeypatch):
        monkeypatch.setenv(fault.SPEC_ENV, "ckpt.commit=1")
        fault.reload_spec()
        m0 = _manager(master, 0, tmp_path, timeout=1.0)
        with pytest.raises(fault.InjectedFault):
            m0.save(_state(), 1)
        assert _counter_total("fault_injected_total", site="ckpt.commit") >= 1
        assert os.listdir(m0.dirname) == []  # tmp cleaned on the error path

    def test_abort_flag_honored_by_peer(self, master, tmp_path):
        """A host that observes a peer's abort flag drops its own tmp even
        if every prepare vote eventually lands."""
        m0 = _manager(master, 0, tmp_path, timeout=5.0)
        m0.coordinator.mark_abort(5, "timeout")  # peer aborted step 5
        m1 = _manager(master, 1, tmp_path, timeout=5.0)
        with pytest.warns(UserWarning, match="aborted"):
            assert m1.save(_state(), 5) is False
        assert os.listdir(m1.dirname) == []

    def test_namespace_isolates_generations(self, master, tmp_path):
        """A stale abort flag from the generation that died must not poison
        the restarted generation's rounds: the supervisor bumps
        PADDLE_TPU_ELASTIC_RESTART_NUM and the coordinator namespaces by it."""
        stale = _manager(master, 0, tmp_path, namespace="ckptbar/0")
        stale.coordinator.mark_abort(1, "timeout")
        m0 = _manager(master, 0, tmp_path, namespace="ckptbar/1")
        m1 = _manager(master, 1, tmp_path, namespace="ckptbar/1")
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.save(_state(), 1))),
            threading.Thread(target=lambda: res.update(b=m1.save(_state(), 1))),
        ])
        assert res == {"a": True, "b": True}

    def test_preemption_publish_routes_through_barrier(self, master,
                                                       tmp_path):
        """SIGTERM's one final save uses the same two-phase commit: both
        hosts' _publish_sync barrier together and publish, or neither."""
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        res = {}
        _join_all([
            threading.Thread(
                target=lambda: res.update(a=m0._publish_sync(_state(), 9))),
            threading.Thread(
                target=lambda: res.update(b=m1._publish_sync(_state(), 9))),
        ])
        assert res == {"a": True, "b": True}
        for m in (m0, m1):
            assert os.path.exists(m.path_for(9))


class TestResumeNegotiation:
    def test_divergent_hosts_resume_from_fleet_committed_step(
            self, master, tmp_path):
        """Regression (satellite): host 0 renamed step 3 just before the
        fleet died, host 1 never did. Resume must pick the barrier-committed
        step 2 on BOTH hosts — never host 0's lexically newest file."""
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        for step in (1, 2):
            res = {}
            _join_all([
                threading.Thread(
                    target=lambda: res.update(a=m0.save(_state(step), step))),
                threading.Thread(
                    target=lambda: res.update(b=m1.save(_state(step), step))),
            ])
            assert res == {"a": True, "b": True}
        # host 0 alone publishes step 3 (plain local save: the rename
        # happened, the fleet's vote on the NEXT round never completed)
        dist_ckpt.save(_state(3), m0.path_for(3))
        assert dist_ckpt.latest_valid(m0.dirname).endswith("ckpt_3")

        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.load_latest())),
            threading.Thread(target=lambda: res.update(b=m1.load_latest())),
        ])
        for key, host in (("a", "host0"), ("b", "host1")):
            state, step = res[key]
            assert step == 2, f"{host} resumed from step {step}, wanted 2"
            np.testing.assert_array_equal(np.asarray(state["w"]),
                                          _state(2)["w"])

    def test_all_hosts_empty_resumes_fresh(self, master, tmp_path):
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.load_latest())),
            threading.Thread(target=lambda: res.update(b=m1.load_latest())),
        ])
        assert res == {"a": None, "b": None}

    def test_one_empty_host_forces_fresh_start(self, master, tmp_path):
        """A host that lost its disk (fresh node joining after restart)
        has nothing: the fleet cannot resume a step that host lacks."""
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        dist_ckpt.save(_state(1), m0.path_for(1))  # only host 0 has data
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=m0.load_latest())),
            threading.Thread(target=lambda: res.update(b=m1.load_latest())),
        ])
        assert res == {"a": None, "b": None}

    def test_negotiation_timeout_raises_and_poisons_round(self, master,
                                                          tmp_path):
        """Consistency over availability: a host whose peers never arrive
        must NOT silently resume its local step (a peer landing just past
        the deadline would resume the fleet minimum — split brain). The
        timeout raises, and the poisoned round makes the late arriver
        raise too instead of resuming alone."""
        m0 = _manager(master, 0, tmp_path, resume_timeout=0.3)
        dist_ckpt.save(_state(4), m0.path_for(4))
        with pytest.raises(RuntimeError, match="negotiation timed out"):
            m0.load_latest()
        # the late arriver finds every key published (its own + host 0's)
        # but the round is poisoned: it must refuse as well
        m1 = _manager(master, 1, tmp_path, resume_timeout=5.0)
        dist_ckpt.save(_state(4), m1.path_for(4))
        with pytest.raises(RuntimeError, match="abandoned by a peer"):
            m1.load_latest()


class TestCoordinatorFromEnv:
    def test_builds_from_trainer_env_contract(self, master, monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(master.port))
        co = coordinator_from_env()
        assert co is not None and co.rank == 1 and co.world_size == 2

    def test_single_host_env_returns_none(self, monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1")
        assert coordinator_from_env() is None

    def test_kill_switch_env(self, master, monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(master.port))
        monkeypatch.setenv("PADDLE_TPU_CKPT_BARRIER", "0")
        assert coordinator_from_env() is None

    def test_garbled_master_port_fails_loudly(self, monkeypatch):
        """A >=2 fleet with an unparseable MASTER_PORT must raise a named
        error, not silently degrade to the single-host path — this host
        would skip the barrier while its peers wait on it."""
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "auto")
        with pytest.raises(ValueError, match="MASTER_PORT"):
            coordinator_from_env()

    def test_missing_rank_fails_loudly(self, master, monkeypatch):
        """A >=2 fleet without PADDLE_TRAINER_ID must raise a named error:
        defaulting to rank 0 would have EVERY host vote as rank 0 and
        each coordinated save burn the barrier timeout."""
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(master.port))
        monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
        with pytest.raises(ValueError, match="PADDLE_TRAINER_ID"):
            coordinator_from_env()

    def test_namespace_follows_restart_num(self, master, monkeypatch):
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(master.port))
        monkeypatch.setenv("PADDLE_TPU_ELASTIC_RESTART_NUM", "4")
        co = coordinator_from_env()
        assert co.namespace == "ckptbar/4"


class TestAbortExitContract:
    """FaultTolerantCheckpoint implements the generation-resync contract:
    persistent coordinated-save aborts exit ELASTIC_EXIT_CODE so the
    elastic supervisors relaunch the whole fleet into one generation."""

    def _cb(self, tmp_path, committed_seq):
        from paddle_tpu_torch.hapi.callbacks import FaultTolerantCheckpoint
        cb = FaultTolerantCheckpoint(str(tmp_path), coordinator=None,
                                     preemption_save=False)
        seq = list(committed_seq)

        class FakeMgr:
            coordinator = object()  # coordinated manager

            def save(self, state, step):
                return seq.pop(0)

            def uninstall_preemption_handler(self):
                pass
        cb.manager = FakeMgr()
        cb._capture = lambda: {}
        return cb

    def test_consecutive_aborts_exit_101(self, tmp_path):
        from paddle_tpu.distributed.fleet.elastic import \
            ELASTIC_EXIT_CODE as JCODE
        from paddle_tpu_torch.distributed.launch import ELASTIC_EXIT_CODE
        assert ELASTIC_EXIT_CODE == JCODE == 101
        cb = self._cb(tmp_path, [False, False])
        cb._save()  # first abort tolerated (transiently slow peer)
        with pytest.raises(SystemExit) as e:
            cb._save()
        assert e.value.code == ELASTIC_EXIT_CODE

    def test_committed_save_resets_the_streak(self, tmp_path):
        cb = self._cb(tmp_path, [False, True, False])
        cb._save()
        cb._save()  # commit resets the abort streak
        cb._save()  # a single new abort: no exit
        assert cb._aborted_saves == 1

    def test_knob_disables_exit(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_CKPT_ABORT_EXIT", "0")
        cb = self._cb(tmp_path, [False] * 5)
        for _ in range(5):
            cb._save()


class TestBarrierKeyGC:
    """Store-key GC for resolved rounds (carried ROADMAP follow-up): each
    host lag-2-deletes its OWN prep key and the round's abort flag once a
    round resolves, so flags stop accreting in the master store for the
    job's lifetime."""

    @staticmethod
    def _round_keys(coord, round_id, step):
        return [coord._k("prep", round_id, step, coord.rank),
                coord._k("abort", round_id, step)]

    def test_resolved_round_keys_are_gced_with_lag_two(self, master,
                                                       tmp_path):
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        n_rounds = 5
        for step in range(1, n_rounds + 1):
            res = {}
            _join_all([
                threading.Thread(
                    target=lambda s=step: res.update(a=m0.save(_state(), s))),
                threading.Thread(
                    target=lambda s=step: res.update(b=m1.save(_state(), s))),
            ])
            assert res == {"a": True, "b": True}
        probe = TCPStore("127.0.0.1", master.port)
        lag = m0.coordinator.GC_LAG
        for m in (m0, m1):
            c = m.coordinator
            # rounds are 0-based; rounds older than newest-lag are gone
            for r in range(n_rounds - lag):
                for key in self._round_keys(c, r, r + 1):
                    assert not probe.check(key), \
                        f"round {r} key {key!r} survived GC"
            # the newest `lag` rounds keep their prep votes (not yet GCd)
            newest = n_rounds - 1
            assert probe.check(c._k("prep", newest, n_rounds, c.rank))
        # bound: per host, at most GC_LAG rounds of keys remain
        assert len(m0.coordinator._round_steps) <= lag
        assert len(m1.coordinator._round_steps) <= lag

    def test_aborted_round_keys_are_gced_too(self, master, tmp_path):
        """Abort flags are exactly what accretes on a flaky fleet — they
        must be GC'd once later rounds prove everyone moved on."""
        m0 = _manager(master, 0, tmp_path, timeout=0.3)
        m1 = _manager(master, 1, tmp_path, timeout=0.3)
        with pytest.warns(UserWarning, match="aborted"):
            assert m0.save(_state(), 1) is False  # round 0: peer missing
        # peer consumes its round 0 too (lockstep, also aborts)
        with pytest.warns(UserWarning, match="aborted"):
            assert m1.save(_state(), 1) is False
        abort_key = m0.coordinator._k("abort", 0, 1)
        probe = TCPStore("127.0.0.1", master.port)
        assert probe.check(abort_key)  # round 0 abort flag exists
        for step in range(2, 5):  # rounds 1..3 commit in lockstep
            res = {}
            _join_all([
                threading.Thread(
                    target=lambda s=step: res.update(a=m0.save(_state(), s))),
                threading.Thread(
                    target=lambda s=step: res.update(b=m1.save(_state(), s))),
            ])
            assert res == {"a": True, "b": True}
        assert not probe.check(abort_key), "aborted round's flag never GCd"

    def test_resume_round_keys_are_gced(self, master, tmp_path):
        m0 = _manager(master, 0, tmp_path)
        m1 = _manager(master, 1, tmp_path)
        for step in (1, 2):
            res = {}
            _join_all([
                threading.Thread(
                    target=lambda s=step: res.update(a=m0.save(_state(), s))),
                threading.Thread(
                    target=lambda s=step: res.update(b=m1.save(_state(), s))),
            ])
            assert res == {"a": True, "b": True}
        for _ in range(4):  # four lockstep resume negotiations
            res = {}
            _join_all([
                threading.Thread(target=lambda: res.update(a=m0.load_latest())),
                threading.Thread(target=lambda: res.update(b=m1.load_latest())),
            ])
            assert res["a"][1] == res["b"][1] == 2
        probe = TCPStore("127.0.0.1", master.port)
        lag = m0.coordinator.GC_LAG
        for m in (m0, m1):
            c = m.coordinator
            newest = c._resume_round
            for r in range(1, newest - lag + 1):
                assert not probe.check(c._k("resume", r, c.rank)), \
                    f"resume round {r} key survived GC"
            assert probe.check(c._k("resume", newest, c.rank))


class TestAcrossPackages:
    def test_port_and_reference_ranks_commit_together(self, master,
                                                      tmp_path):
        """One round, rank 0 the reference's coordinator and manager, rank
        1 the port's, both on the port's store: the protocol (its keys,
        rounds and votes) is the same, so both publish step 1 and a later
        resume agrees, each reading its own file."""
        from paddle_tpu.distributed import checkpoint as jckpt
        jstore = TCPStore("127.0.0.1", master.port)
        j = jckpt.CheckpointManager(
            str(tmp_path / "ref"), coordinator=jckpt.CheckpointCoordinator(
                jstore, 0, 2, timeout=5.0, poll_interval=0.005))
        t = _manager(master, 1, tmp_path)
        res = {}
        _join_all([
            threading.Thread(target=lambda: res.update(a=j.save(_state(), 1))),
            threading.Thread(target=lambda: res.update(b=t.save(_state(), 1))),
        ])
        assert res == {"a": True, "b": True}
        _join_all([
            threading.Thread(target=lambda: res.update(a=j.load_latest())),
            threading.Thread(target=lambda: res.update(b=t.load_latest())),
        ])
        assert res["a"][1] == res["b"][1] == 1
        np.testing.assert_array_equal(np.asarray(res["a"][0]["w"]),
                                      np.asarray(res["b"][0]["w"]))
