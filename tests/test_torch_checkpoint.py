"""The port's checkpoint plane (paddle_tpu_torch.framework.io,
.framework.random, .distributed.checkpoint, .fault) against the JAX
package, on the CPU.

Files cross packages: a CheckpointManager file written by either package
loads in the other leaf for leaf and bit for bit, bf16 leaves included
in both directions (the port writes the reference's ml_dtypes bf16
array form without importing ml_dtypes, and reads it back into a
torch.bfloat16 tensor). The ``rng`` leaf is each package's own: the
port's holds torch's and numpy's generator states; a JAX key is left
alone with a warning. Corruption is named as the reference names it.
Fault specs parse as the reference parses them (the cases of
tests/test_fault.py).
"""
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import fault as jfault
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.framework import io as jio
from paddle_tpu_torch import fault, framework
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.profiler import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(rng):
    """One checkpoint-shaped tree in numpy, with a bf16 leaf."""
    return {
        "network": {
            "w": rng.normal(size=(4, 3)).astype(np.float32),
            "b16": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
        },
        "train_step": {"t": 7, "opt_flat": [
            rng.normal(size=(3,)).astype(np.float32),
            rng.normal(size=(2, 2)).astype(ml_dtypes.bfloat16)]},
        "epoch": 1, "step_in_epoch": 2, "epoch_done": False,
        "lr": np.float32(0.25), "name": "gpt", "nested": [(1, 2.5), None],
    }


def _to_port(x):
    """The numpy tree as the port holds it (tensors; bf16 as torch bf16)."""
    if isinstance(x, np.ndarray):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_port(v) for v in x]
    return x


def _bits(x):
    """Raw bits of a leaf of either package, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return ("bf16", x.view(torch.int16).numpy())
        return (str(x.dtype).replace("torch.", ""), x.numpy())
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return ("bf16", a.view(np.int16))
    return (str(a.dtype), a)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif hasattr(a, "shape") and hasattr(b, "shape"):
        (ta, xa), (tb, xb) = _bits(a), _bits(b)
        assert ta == tb and xa.shape == xb.shape
        np.testing.assert_array_equal(xa, xb)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manager_files_cross_packages(tmp_path, writer):
    tree = _tree(np.random.default_rng(0))
    if writer == "port":
        mgr = ckpt.CheckpointManager(str(tmp_path), keep_last_n=2)
        mgr.save(_to_port(tree), step=3)
        got, step = jckpt.CheckpointManager(str(tmp_path)).load_latest()
    else:
        jckpt.CheckpointManager(str(tmp_path)).save(tree, step=3)
        got, step = ckpt.CheckpointManager(str(tmp_path)).load_latest()
        assert got["network"]["b16"].dtype == torch.bfloat16
        assert isinstance(got["network"]["w"], torch.Tensor)
    assert step == 3
    _same_tree(tree, got)
    ok, _ = ckpt.verify(str(tmp_path / "ckpt_3"))
    assert ok and jckpt.verify(str(tmp_path / "ckpt_3"))[0]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_paddle_save_load_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 2)).astype(np.float32)
    h = rng.normal(size=(4,)).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "m.pdparams")
    if writer == "port":
        tio.save({"w": torch.from_numpy(w), "h": _to_port(h), "step": 3},
                 path)
        got = jio.load(path)
        np.testing.assert_array_equal(np.asarray(got["w"].data), w)
        np.testing.assert_array_equal(
            np.asarray(got["h"].data).view(np.int16), h.view(np.int16))
    else:
        jio.save({"w": paddle.to_tensor(w), "h": paddle.to_tensor(h),
                  "step": 3}, path)
        got = tio.load(path)
        np.testing.assert_array_equal(got["w"].numpy(), w)
        assert got["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["h"].view(torch.int16).numpy(),
                                      h.view(np.int16))
        np.testing.assert_array_equal(tio.load(path, return_numpy=True)["w"],
                                      w)
    assert got["step"] == 3


def test_loading_never_imports_the_jax_package(tmp_path):
    """A pickle naming a JAX global is refused, not imported (the
    reference converts every array to numpy before writing)."""
    bad = tmp_path / "bad"
    bad.write_bytes(pickle.dumps({"state": paddle.to_tensor(
        np.ones(2, np.float32))}, protocol=4))
    with pytest.raises(ckpt.CheckpointCorruptError, match="refusing"):
        ckpt.load(str(bad))


def test_cipher_key_waits_for_a12(tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        tio.save({"w": torch.ones(2)}, str(tmp_path / "x"), cipher_key=b"k" * 16)
    with pytest.raises(NotImplementedError, match="A12"):
        tio.load(str(tmp_path / "x"), cipher_key=b"k" * 16)


def test_async_save_snapshots_before_it_returns(tmp_path):
    """The port's update is in place: a tensor written into after save()
    returns must not reach the file."""
    w = torch.zeros(1000)
    path = str(tmp_path / "ckpt_1")
    ckpt.save({"w": w}, path, async_save=True)
    w.fill_(1.0)
    ckpt.wait_all()
    assert torch.equal(ckpt.load(path)["w"], torch.zeros(1000))


# ------------------------------ corruption -----------------------------------


def _corrupt(path, how):
    data = open(path, "rb").read()
    if how == "truncated":
        data = data[:len(data) // 2]
    elif how == "bitflip":
        data = bytearray(data)
        data[-10] ^= 0x40
        data = bytes(data)
    else:
        data = b""
    open(path, "wb").write(data)


@pytest.mark.parametrize("how,reason", [("truncated", "payload truncated"),
                                        ("bitflip", "CRC32 mismatch"),
                                        ("empty", "empty file")])
def test_verify_names_corruption_as_the_reference(tmp_path, how, reason):
    path = str(tmp_path / "ckpt_1")
    ckpt.save({"w": torch.arange(64.0)}, path)
    _corrupt(path, how)
    ok, got = ckpt.verify(path)
    jok, want = jckpt.verify(path)
    assert not ok and not jok and reason in got
    assert got == want
    with pytest.raises(ckpt.CheckpointCorruptError, match=reason):
        ckpt.load(path)


def test_manager_gc_and_corrupt_fallback(tmp_path):
    reg = metrics.default_registry()
    skipped = reg.get("checkpoint_corrupt_skipped_total")
    before = skipped.total()
    (tmp_path / "ckpt_1.tmp.orphan").write_bytes(b"x")
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last_n=2)
    assert not (tmp_path / "ckpt_1.tmp.orphan").exists()
    for s in (1, 2, 3):
        mgr.save({"s": torch.tensor(float(s))}, step=s)
    assert mgr.steps() == [3, 2]
    _corrupt(mgr.path_for(3), "truncated")
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        state, step = mgr.load_latest()
    assert step == 2 and float(state["s"]) == 2.0
    assert skipped.total() == before + 1
    assert ckpt.latest(str(tmp_path)) == mgr.path_for(3)
    assert ckpt.CheckpointManager(str(tmp_path / "empty")).load_latest() \
        is None


def test_valid_only_resume_walks_past_nonfinite(tmp_path, monkeypatch):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save({"network": {"w": torch.ones(2)}}, step=1)
    mgr.save({"network": {"w": torch.tensor([1.0, float("nan")])}}, step=2)
    assert mgr.load_latest()[1] == 2
    monkeypatch.setenv("PADDLE_TPU_RESUME_VALID_ONLY", "1")
    with pytest.warns(UserWarning, match="numerically-invalid"):
        assert mgr.load_latest()[1] == 1
    assert not ckpt.tree_finite({"a": [torch.tensor([float("inf")])]})
    assert ckpt.tree_finite({"a": np.ones(2), "b": "x"})


def test_multi_host_pieces_wait_for_a11(tmp_path, monkeypatch):
    # the coordinated commit is ported (tests/test_torch_coord_checkpoint.py
    # holds it against the reference); the sharded layout opens its manager
    # (tests/test_torch_sharded_ckpt.py holds it against the reference)
    from paddle_tpu_torch.distributed.store import TCPStore
    assert ckpt.coordinator_from_env() is None
    master = TCPStore("127.0.0.1", 0, is_master=True)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(master.port))
    co = ckpt.coordinator_from_env()
    assert (co.rank, co.world_size) == (1, 2)
    (tmp_path / "ckpt_4").mkdir()
    assert ckpt.detect_layout(str(tmp_path)) == "sharded"
    assert ckpt.open_manager(str(tmp_path)).layout == "sharded"
    with pytest.raises(ValueError, match="world_size"):
        ckpt.CheckpointCoordinator(None, 0, 1)
    master.stop()


# ------------------------------- preemption ----------------------------------


def test_preemption_save_on_sigterm_in_a_subprocess(tmp_path):
    script = textwrap.dedent(f"""
        import os, signal, sys, time
        sys.path.insert(0, {REPO!r})
        import torch
        from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
        mgr = CheckpointManager({str(tmp_path)!r})
        calls = []
        def state():
            calls.append(1)
            return {{"final": True, "w": torch.arange(4.0)}}
        assert mgr.install_preemption_handler(state, step_fn=lambda: 99)
        print("ready", flush=True)
        time.sleep(60)
    """)
    p = subprocess.Popen([sys.executable, "-c", script],
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "ready"
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    assert rc == 143
    state, step = ckpt.CheckpointManager(str(tmp_path)).load_latest()
    assert step == 99 and state["final"] is True
    assert torch.equal(state["w"], torch.arange(4.0))


# ------------------------------- RNG state -----------------------------------


def test_rng_state_round_trip():
    trandom.seed(5)
    np.random.seed(6)
    st = framework.get_rng_state()
    assert st.dtype == np.uint8
    want = (torch.rand(3), np.random.rand(2))
    torch.rand(7)
    np.random.rand(7)
    assert framework.set_rng_state(st)
    got = (torch.rand(3), np.random.rand(2))
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_a_jax_rng_leaf_is_left_alone():
    trandom.seed(5)
    want = torch.rand(3)
    trandom.seed(5)
    key = np.asarray(paddle.framework.random.get_rng_state())
    with pytest.warns(UserWarning, match="not written by paddle_tpu_torch"):
        assert not trandom.set_rng_state(key)
    assert torch.equal(torch.rand(3), want)


# ------------------------------- fault specs ---------------------------------


def _fires(inj, site, exc_types):
    try:
        inj.site(site)
    except exc_types as e:
        return type(e).__name__
    return None


@pytest.mark.parametrize("spec,calls", [
    ("a.b=1; c.d=2@3:timeout ; e.f=1:oserror",
     ["a.b", "a.b", "c.d", "c.d", "c.d", "c.d", "c.d", "e.f"]),
    ("s.op=2@3", ["s.op"] * 6),
    ("x=1:delay;y=0", ["x", "y", "x"]),
])
def test_fault_specs_parse_as_in_the_reference(spec, calls, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0")
    ours, theirs = fault.FaultInjector(spec=spec), \
        jfault.FaultInjector(spec=spec)
    excs = (fault.InjectedFault, fault.InjectedTimeout,
            fault.InjectedIOError)
    jexcs = (jfault.InjectedFault, jfault.InjectedTimeout,
             jfault.InjectedIOError)
    got = [_fires(ours, c, excs) for c in calls]
    want = [_fires(theirs, c, jexcs) for c in calls]
    assert got == want
    assert any(got) or spec.startswith("x=")
    for c in set(calls):
        assert ours.fired(c) == theirs.fired(c)


def test_malformed_fault_clause_warns_as_in_the_reference():
    with pytest.warns(UserWarning, match="malformed clause"):
        inj = fault.FaultInjector(spec="good.site=1;bad_clause;also=bad!x")
    with pytest.raises(fault.InjectedFault):
        inj.site("good.site")
    assert set(fault.inject.KNOWN_SITES) == {
        "serving.decode", "serving.wedge", "serving.admit", "heter.pull",
        "heter.push", "store.get", "store.set", "store.add", "store.check",
        "parallel.init", "collective.timeout", "ckpt.commit",
        "ckpt.chunk_write", "ckpt.reshard"}
    assert set(fault.inject.KNOWN_SITES) <= set(jfault.inject.KNOWN_SITES)
    assert set(fault.inject.DYNAMIC_SITES) == {"ps."}
    assert set(fault.inject.DYNAMIC_SITES) <= set(
        jfault.inject.DYNAMIC_SITES)


def test_retry_policy_schedule_matches_the_reference():
    ours = fault.RetryPolicy(max_attempts=4, base_delay=0.01, seed=3)
    theirs = jfault.RetryPolicy(max_attempts=4, base_delay=0.01, seed=3)
    assert [ours.delay(i) for i in range(3)] == \
        [theirs.delay(i) for i in range(3)]
    n = {"k": 0}

    def flaky():
        n["k"] += 1
        if n["k"] < 3:
            raise ConnectionError("transient")
        return "ok"

    t0 = time.perf_counter()
    assert fault.retry_call(flaky, op="t", policy=fault.RetryPolicy(
        max_attempts=3, base_delay=0.0)) == "ok"
    assert time.perf_counter() - t0 < 5


# ------------------------- Paddle's own file format --------------------------


def test_paddle_format_and_match_state_dict_as_in_the_reference(tmp_path):
    """A state dict as Paddle's paddle.save writes it (a name table, a big
    parameter split into slices, protocol 2) decodes alike in both
    packages, and match_state_dict strips a wrapping prefix alike."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    raw = {"net.fc.bias": b, "net.fc.weight@@.0": w.ravel()[:10],
           "net.fc.weight@@.1": w.ravel()[10:], "cls.head": np.ones(2),
           "StructuredToParameterName@@": {"net.fc.weight": "p0"},
           "UnpackBigParamInfor@@": {"net.fc.weight": {
               "OriginShape": w.shape,
               "slices": ["net.fc.weight@@.0", "net.fc.weight@@.1"]}}}
    path = str(tmp_path / "m.pdparams")
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)
    got, want = tio.load(path), jio.load(path)
    assert got.keys() == want.keys() == {"net.fc.weight", "net.fc.bias",
                                         "cls.head"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k].data))
    net = torch.nn.Module()
    net.fc = torch.nn.Linear(6, 4)
    matched, missing, unexpected = tio.match_state_dict(
        net, {"net.fc.weight": got["net.fc.weight"].T,
              "net.fc.bias": got["net.fc.bias"], "cls.head": 0})
    assert set(matched) == {"fc.weight", "fc.bias"}
    assert missing == [] and unexpected == ["cls.head"]
