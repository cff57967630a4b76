"""The port's parameter server against the JAX package's, on the CPU.

Each test runs a reference `PSServer` and a port `PSServer` on port 0 (the
port's is its own copy of the table server, built with g++ from
``paddle_tpu_torch/_native/host_csrc``) and stops both. The same inputs,
made from a seed with numpy, go through both packages: the servers hand
out the same rows for the same key and seed, the eager Wide&Deep loop with
the reference's dense weights gives the same losses, parameters and
server rows, and so do DeepFM, ``BCEWithLogitsLoss``, the client's
multi-table pull and the hot-row cache's lifecycle.

Tolerances: rows straight from a server are compared bit for bit; after
training, fp32 values are held to 1e-5 absolute (losses, parameters, rows:
the two packages sum the same fp32 terms in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.ps import PSClient as JClient
from paddle_tpu.distributed.ps import PSServer as JServer
from paddle_tpu.distributed.ps import TableConfig as JTable
from paddle_tpu.models.deepfm import DeepFM as JDeepFM
from paddle_tpu.models.wide_deep import WideDeep as JWideDeep
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.ps import (Communicator, GeoCommunicator,
                                             PSClient, PSServer, TableConfig,
                                             runtime)
from paddle_tpu_torch.distributed.ps.cache import HotRowCache
from paddle_tpu_torch.models import DeepFM, WideDeep, load_dense_params
from paddle_tpu_torch.nn import functional as F

B, SLOTS, VOCAB, DIM, HIDDEN = 32, 4, 1000, 8, 16
ATOL = 1e-5


@pytest.fixture()
def pair():
    """(reference client, port client), each on its own fresh server."""
    js = JServer(0)
    jc = JClient([js.endpoint])
    ps = PSServer(0)
    pc = PSClient([ps.endpoint])
    yield jc, pc
    pc.stop_servers()
    jc.stop_servers()
    ps.stop()
    js.stop()


def _batches(n, seed=0, dense_dim=SLOTS):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (B, SLOTS)).astype(np.int64),
             rng.normal(size=(B, dense_dim)).astype(np.float32),
             (rng.random((B, 1)) > 0.5).astype(np.float32))
            for _ in range(n)]


def _models(jc, pc, cls=(JWideDeep, WideDeep), **kw):
    """The reference model (paddle.seed(0)) and the port's with its dense
    weights carried across."""
    paddle.seed(0)
    jm = cls[0](client=jc, **kw)
    pm = cls[1](client=pc, device="cpu", **kw)
    load_dense_params(pm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    return jm, pm


def _rows(client, tids, keys):
    keys = np.asarray(keys, np.uint64)
    return {t: client.pull_sparse(t, keys).copy() for t in tids}


@pytest.mark.parametrize("cfg", [
    dict(table_id=0, dim=8, init_range=0.05, seed=0),
    dict(table_id=3, dim=1, init_range=0.05, seed=0),
    dict(table_id=7, dim=16, init_range=0.5, seed=1234),
    dict(table_id=9, dim=5, optimizer="adagrad", init_range=0.1, seed=7),
])
def test_both_servers_hand_out_the_same_rows(pair, cfg):
    jc, pc = pair
    jc.create_table(JTable(kind="sparse", **cfg))
    pc.create_table(TableConfig(kind="sparse", **cfg))
    keys = np.random.default_rng(1).integers(
        0, 2**63, 257, dtype=np.int64).astype(np.uint64)
    keys[:3] = [0, 1, VOCAB - 1]
    np.testing.assert_array_equal(pc.pull_sparse(cfg["table_id"], keys),
                                  jc.pull_sparse(cfg["table_id"], keys))
    assert pc.table_size(cfg["table_id"]) == jc.table_size(cfg["table_id"])


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "sum"])
def test_sparse_push_updates_rows_as_the_reference(pair, opt):
    jc, pc = pair
    for c, T in ((jc, JTable), (pc, TableConfig)):
        c.create_table(T(table_id=1, kind="sparse", dim=4, optimizer=opt,
                         learning_rate=0.1, seed=3))
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 50, 40).astype(np.uint64)
    for _ in range(3):
        g = rng.normal(size=(keys.size, 4)).astype(np.float32)
        jc.push_sparse(1, keys, g)
        pc.push_sparse(1, keys, g)
    np.testing.assert_array_equal(pc.pull_sparse(1, np.arange(50)),
                                  jc.pull_sparse(1, np.arange(50)))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dense_tables_as_the_reference(pair, opt):
    jc, pc = pair
    init = np.linspace(-1, 1, 37).astype(np.float32)
    for c, T in ((jc, JTable), (pc, TableConfig)):
        c.create_table(T(table_id=2, kind="dense", dense_size=37,
                         optimizer=opt, learning_rate=0.05))
        c.set_dense(2, init)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = rng.normal(size=37).astype(np.float32)
        jc.push_dense(2, g)
        pc.push_dense(2, g)
    np.testing.assert_array_equal(pc.pull_dense(2), jc.pull_dense(2))


def test_save_load_roundtrip(pair, tmp_path):
    _, pc = pair
    pc.create_table(TableConfig(table_id=0, kind="sparse", dim=4))
    keys = np.arange(20, dtype=np.uint64)
    pc.push_sparse(0, keys, np.ones((20, 4), np.float32))
    before = pc.pull_sparse(0, keys).copy()
    pc.save(str(tmp_path))
    pc.push_sparse(0, keys, np.ones((20, 4), np.float32))
    pc.load(str(tmp_path))
    np.testing.assert_array_equal(pc.pull_sparse(0, keys), before)


def test_pull_sparse_multi_matches_serial_pulls(pair):
    _, pc = pair
    rng = np.random.default_rng(0)
    for tid in range(3):
        pc.create_table(TableConfig(table_id=tid, kind="sparse", dim=4,
                                    seed=tid))
    reqs = [(tid, rng.integers(0, 1000, 64).astype(np.uint64))
            for tid in range(3)]
    reqs.append((1, np.empty(0, np.uint64)))  # an empty request rides along
    multi = pc.pull_sparse_multi(reqs)
    serial = [pc.pull_sparse(tid, keys) for tid, keys in reqs]
    assert len(multi) == len(serial)
    for m, s in zip(multi, serial):
        np.testing.assert_array_equal(m, s)
    (one,) = pc.pull_sparse_multi([(2, reqs[2][1])])
    np.testing.assert_array_equal(one, serial[2])


def test_two_servers_shard_keys_as_the_reference():
    servers = [PSServer(0), PSServer(0)]
    jservers = [JServer(0), JServer(0)]
    pc = PSClient([s.endpoint for s in servers])
    jc = JClient([s.endpoint for s in jservers])
    try:
        for c, T in ((jc, JTable), (pc, TableConfig)):
            c.create_table(T(table_id=0, kind="sparse", dim=4))
        keys = np.arange(101, dtype=np.uint64)
        g = np.random.default_rng(0).normal(size=(101, 4)).astype(np.float32)
        jc.push_sparse(0, keys, g)
        pc.push_sparse(0, keys, g)
        np.testing.assert_array_equal(pc.pull_sparse(0, keys),
                                      jc.pull_sparse(0, keys))
        sizes = [c.table_size(0) for c in (PSClient([servers[0].endpoint]),
                                           PSClient([servers[1].endpoint]))]
        assert sizes == [51, 50]
    finally:
        pc.stop_servers()
        jc.stop_servers()


def test_eager_wide_deep_loop_with_carried_weights(pair):
    """3 eager steps (Adam 1e-2 on the dense tower, server SGD 0.05) in
    each package: losses, dense parameters and the rows on the servers
    after the pushes agree to 1e-5."""
    jc, pc = pair
    kw = dict(num_slots=SLOTS, embedding_dim=DIM, dense_dim=SLOTS,
              hidden=HIDDEN)
    jm, pm = _models(jc, pc, **kw)
    jo = jopt.Adam(learning_rate=1e-2, parameters=jm.parameters())
    po = optimizer.Adam(learning_rate=1e-2, parameters=pm.parameters())
    jcrit, pcrit = jnn.BCEWithLogitsLoss(), nn.BCEWithLogitsLoss()
    jl, pl = [], []
    data = _batches(3)
    keys = np.unique(np.concatenate([d[0].ravel() for d in data]))
    tids = range(SLOTS + 1)
    for e in [*pm.embeddings, pm.wide]:
        e._ensure_table()
    fresh = _rows(pc, tids, keys)
    for ids, dense, y in data:
        loss = jcrit(jm(paddle.to_tensor(ids), paddle.to_tensor(dense)),
                     paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss))
        loss = pcrit(pm(torch.from_numpy(ids), torch.from_numpy(dense)),
                     torch.from_numpy(y))
        loss.backward()
        po.step()
        po.clear_grad()
        pl.append(loss.item())
    np.testing.assert_allclose(pl, jl, rtol=0, atol=ATOL)
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=0,
                                   atol=ATOL)
    ref, got = _rows(jc, tids, keys), _rows(pc, tids, keys)
    for t in tids:
        np.testing.assert_allclose(got[t], ref[t], rtol=0, atol=ATOL)
        assert not np.array_equal(got[t], fresh[t])  # the pushes landed


def test_sparse_embedding_merges_duplicate_ids(pair):
    """A batch of one id pushes ONE merged row: the sum of its gradients
    (np.add.at in the reference), so SGD moves it by lr * sum."""
    _, pc = pair
    from paddle_tpu_torch.distributed.ps import SparseEmbedding
    emb = SparseEmbedding(0, 4, learning_rate=0.5, client=pc, device="cpu")
    ids = torch.full((6,), 7, dtype=torch.int64)
    emb._ensure_table()
    before = pc.pull_sparse(0, np.array([7], np.uint64)).copy()
    out = emb(ids)
    assert out.shape == (6, 4)
    (out * torch.arange(6.0)[:, None]).sum().backward()
    after = pc.pull_sparse(0, np.array([7], np.uint64))
    np.testing.assert_allclose(after, before - 0.5 * 15.0, rtol=0, atol=1e-6)
    assert list(emb.parameters()) == []
    with torch.no_grad():  # no gradient asked: no push
        emb(ids)
    np.testing.assert_array_equal(
        pc.pull_sparse(0, np.array([7], np.uint64)), after)


def test_deepfm_forward_and_one_step(pair):
    jc, pc = pair
    kw = dict(num_slots=SLOTS, embedding_dim=DIM, hidden=HIDDEN)
    jm, pm = _models(jc, pc, cls=(JDeepFM, DeepFM), **kw)
    ids, _, y = _batches(1, seed=3)[0]
    with torch.no_grad():
        fwd = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(fwd, np.asarray(jm(paddle.to_tensor(ids)).data),
                               rtol=0, atol=ATOL)
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    po = optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())
    jl = jnn.BCEWithLogitsLoss()(jm(paddle.to_tensor(ids)),
                                 paddle.to_tensor(y))
    jl.backward()
    jo.step()
    pl = nn.BCEWithLogitsLoss()(pm(torch.from_numpy(ids)),
                                torch.from_numpy(y))
    pl.backward()
    po.step()
    assert abs(pl.item() - float(jl)) < ATOL
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    for k, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=0,
                                   atol=ATOL)
    tids = range(100, 100 + SLOTS + 1)
    ref, got = _rows(jc, tids, np.unique(ids)), _rows(pc, tids,
                                                      np.unique(ids))
    for t in tids:
        np.testing.assert_allclose(got[t], ref[t], rtol=0, atol=ATOL)


@pytest.mark.parametrize("weight", [False, True])
@pytest.mark.parametrize("pos_weight", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_with_logits_matches_reference(weight, pos_weight, reduction):
    rng = np.random.default_rng(5)
    z = (rng.normal(size=(16, 3)) * 30).astype(np.float32)  # saturating too
    y = (rng.random((16, 3)) > 0.5).astype(np.float32)
    w = rng.random((16, 3)).astype(np.float32) if weight else None
    pw = (rng.random(3) * 3).astype(np.float32) if pos_weight else None
    ref = jnn.BCEWithLogitsLoss(
        None if w is None else paddle.to_tensor(w), reduction,
        None if pw is None else paddle.to_tensor(pw), "bce")(
            paddle.to_tensor(z), paddle.to_tensor(y))
    got = nn.BCEWithLogitsLoss(
        None if w is None else torch.from_numpy(w), reduction,
        None if pw is None else torch.from_numpy(pw), "bce")(
            torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.data), rtol=1e-6,
                               atol=1e-5)
    fz = torch.from_numpy(z).requires_grad_(True)
    F.binary_cross_entropy_with_logits(fz, torch.from_numpy(y)).backward()
    assert torch.isfinite(fz.grad).all()


def _cache_round(cache, client, tid, keys, bucket=None):
    """plan -> pull misses -> commit -> combine: (plan, plan_dev, rows)."""
    uniq = np.asarray(keys, np.uint64)
    plan = cache.plan(uniq, bucket or uniq.size)
    miss = (client.pull_sparse(tid, plan.miss_keys) if plan.miss_keys.size
            else np.zeros((1, cache.dim), np.float32))
    cache.commit(plan)
    plan_dev = tuple(torch.from_numpy(a) for a in
                     (plan.slot_idx, plan.hit_mask, plan.miss_idx))
    return plan, plan_dev, cache.combine(plan_dev, torch.from_numpy(miss))


def test_cache_padded_and_overflow_positions_touch_no_slot(pair):
    """The trash row: a padded tail and keys that found no slot gather 0
    and leave values/gsum of every real slot untouched."""
    _, pc = pair
    pc.create_table(TableConfig(table_id=5, kind="sparse", dim=3))
    cache = HotRowCache(5, 3, capacity=2, learning_rate=0.5, client=pc,
                        device="cpu")
    keys = np.array([10, 11, 12], np.uint64)  # 3 keys, 2 slots: 1 overflow
    plan, plan_dev, rows = _cache_round(cache, pc, 5, keys, bucket=8)
    assert plan.overflow == [2] and len(cache) == 2
    assert (plan.slot_idx[2:] == cache.capacity).all()
    gathered = cache._vbuf.index_select(0, plan_dev[0])
    assert not gathered[2:].any()  # sentinel positions read 0
    g = torch.ones((8, 3))
    cache.apply(plan_dev, rows, g)
    server = pc.pull_sparse(5, keys[:2])
    np.testing.assert_allclose(cache.values[plan.slot_idx[:2]].numpy(),
                               server - 0.5, rtol=0, atol=1e-6)
    assert (cache.gsum[plan.slot_idx[:2]] == 1.0).all()
    assert cache.values.shape == (2, 3) and cache.gsum.shape == (2, 3)
    assert not cache._vbuf[-1].any() and not cache._gbuf[-1].any()


def test_shrink_flushes_then_invalidates(pair):
    _, pc = pair
    tid, dim, lr = 60, 4, 0.5
    pc.create_table(TableConfig(table_id=tid, kind="sparse", dim=dim,
                                optimizer="sgd", learning_rate=lr,
                                init_range=0.1, seed=11))
    cache = HotRowCache(tid, dim, capacity=8, learning_rate=lr, client=pc,
                        device="cpu")
    other = HotRowCache(tid + 1, dim, capacity=8, learning_rate=lr,
                        client=pc, device="cpu")
    pc.create_table(TableConfig(table_id=tid + 1, kind="sparse", dim=dim))
    _cache_round(other, pc, tid + 1, np.array([3], np.uint64))
    k = np.array([7], np.uint64)
    row0 = pc.pull_sparse(tid, k).copy()
    plan, plan_dev, rows = _cache_round(cache, pc, tid, k)
    assert not plan.hit_mask[0]
    np.testing.assert_allclose(rows[0].numpy(), row0[0], atol=1e-6)
    g = torch.full((1, dim), 0.25)
    cache.apply(plan_dev, rows, g)
    assert pc.shrink(tid, threshold=-1.0, max_unseen_days=30) == 0
    assert len(cache) == 0 and cache.stats["invalidation"] == 1
    assert not cache.gsum.any()
    np.testing.assert_allclose(pc.pull_sparse(tid, k)[0],
                               row0[0] - lr * 0.25, atol=1e-6)
    assert len(other) == 1 and other.stats["invalidation"] == 0
    _cache_round(cache, pc, tid, k)
    for _ in range(3):
        pc.shrink(tid, threshold=1.0, max_unseen_days=1)
    assert pc.pull_meta(tid, k)[2][0] == -1  # evicted on the server
    assert len(cache) == 0
    plan2, _, fresh = _cache_round(cache, pc, tid, k)
    assert not plan2.hit_mask[0]
    np.testing.assert_allclose(fresh[0].numpy(), pc.pull_sparse(tid, k)[0],
                               atol=1e-6)


def test_communicator_merges_and_flushes(pair):
    _, pc = pair
    pc.create_table(TableConfig(table_id=0, kind="sparse", dim=2,
                                learning_rate=1.0))
    comm = Communicator(pc, merge_size=100, send_wait_ms=10000)
    comm.start()
    keys = np.array([1, 2, 1], np.uint64)
    before = pc.pull_sparse(0, np.array([1, 2], np.uint64)).copy()
    comm.push_sparse(0, keys, np.ones((3, 2), np.float32))
    comm.flush()
    after = comm.pull_sparse(0, np.array([1, 2], np.uint64))
    np.testing.assert_allclose(after, before - [[2.0, 2.0], [1.0, 1.0]],
                               atol=1e-6)
    comm.stop()


def test_geo_sum_table_merges_deltas(pair):
    _, pc = pair
    pc.create_table(TableConfig(table_id=0, kind="sparse", dim=2,
                                optimizer="sum"))
    geo = GeoCommunicator(pc, lr=0.5, geo_push_steps=2)
    k = np.array([4], np.uint64)
    base = pc.pull_sparse(0, k).copy()
    geo.pull_sparse(0, k)
    geo.push_sparse(0, k, np.ones((1, 2), np.float32))
    np.testing.assert_array_equal(pc.pull_sparse(0, k), base)  # local only
    geo.push_sparse(0, k, np.ones((1, 2), np.float32))  # second step: sync
    np.testing.assert_allclose(pc.pull_sparse(0, k), base - 1.0, atol=1e-6)


def test_runtime_roles_and_env(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    assert runtime.is_server() and not runtime.is_worker()
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    e = env.get_cluster_env()
    assert (e.rank, e.world_size, e.nranks) == (3, 4, 4)
    assert isinstance(env.find_free_port(), int)
    srv = runtime.init_server(0)
    try:
        client = runtime.init_worker([srv.endpoint])
        assert runtime.get_client() is client
        client.create_table(TableConfig(table_id=0, kind="sparse", dim=2))
        assert client.pull_sparse(0, np.arange(3)).shape == (3, 2)
    finally:
        runtime.shutdown()


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WideDeep()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepFM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HotRowCache(0, 2, 4, 0.1, client=None)


def test_failed_host_build_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch._native import host
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(host, "_CSRC", bad)
    monkeypatch.setattr(host, "_BUILD", tmp_path)
    monkeypatch.setattr(host, "_LIB", tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.build()
    assert not (tmp_path / "lib.so").exists()
