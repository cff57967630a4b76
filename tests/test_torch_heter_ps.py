"""The port's ``HeterPSTrainStep`` against the JAX package's, on the CPU.

Wide&Deep at small widths (B 32, 4 slots, ids in [0, 1000), dim 8, hidden
16) over a reference `PSServer` and a port `PSServer` on port 0, the dense
weights carried across: the sync step and the pipelined step with the
hot-row cache give the reference's losses, dense parameters and server
rows. The port's own contracts are held as the reference's tests hold
them: staleness of at most one step with and without ``prefetch``,
eviction write-back equal to pushing every step (an SGD and a "sum"
table), a non-SGD table skipped with a warning, injected ``heter.pull`` /
``heter.push`` faults recovered, a batch-shape change, the routing pass
computing no dense value, and the captured route through a CPU stand-in of
``StepGraphs``.

Tolerances: fp32 losses, parameters and rows to 1e-5 absolute against the
reference; inside the port (sync step against the eager loop, the graph
route against the uncaptured one) to 1e-6.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.ps import PSClient as JClient
from paddle_tpu.distributed.ps import PSServer as JServer
from paddle_tpu.distributed.ps.heter import HeterPSTrainStep as JHeter
from paddle_tpu.models.wide_deep import WideDeep as JWideDeep
from paddle_tpu_torch import fault, nn, optimizer
from paddle_tpu_torch.distributed.ps import PSClient, PSServer, SparseEmbedding
from paddle_tpu_torch.distributed.ps.heter import HeterPSTrainStep
from paddle_tpu_torch.models import DeepFM, WideDeep, load_dense_params
from paddle_tpu_torch.profiler import metrics

B, SLOTS, VOCAB, DIM, HIDDEN = 32, 4, 1000, 8, 16
ATOL = 1e-5


def _server():
    s = PSServer(0)
    return s, PSClient([s.endpoint])


@pytest.fixture()
def ps():
    s, c = _server()
    yield c
    c.stop_servers()
    s.stop()


@pytest.fixture()
def pair():
    js = JServer(0)
    jc = JClient([js.endpoint])
    s, c = _server()
    yield jc, c
    c.stop_servers()
    jc.stop_servers()
    s.stop()
    js.stop()


@pytest.fixture(autouse=True)
def _clean_faults():
    fault.reset()
    yield
    fault.reset()


def _data(n=6, seed=0, vocab=VOCAB, b=B, partial_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bb = 5 if i == partial_at else b
        ids = rng.integers(0, vocab, (bb, SLOTS)).astype(np.int64)
        dense = rng.normal(size=(bb, SLOTS)).astype(np.float32)
        y = ((ids.sum(1) % 2) == 0).astype(np.float32)[:, None]
        out.append((torch.from_numpy(ids), torch.from_numpy(dense),
                    torch.from_numpy(y)))
    return out


def _ref_weights(jc=None):
    paddle.seed(0)
    jm = JWideDeep(num_slots=SLOTS, embedding_dim=DIM, dense_dim=SLOTS,
                   hidden=HIDDEN, client=jc)
    return jm, {k: np.asarray(p.data) for k, p in jm.named_parameters()}


_WEIGHTS = {}


def _model(client):
    """The port's Wide&Deep with the reference's dense weights."""
    if "w" not in _WEIGHTS:
        _WEIGHTS["w"] = _ref_weights()[1]
    m = WideDeep(num_slots=SLOTS, embedding_dim=DIM, dense_dim=SLOTS,
                 hidden=HIDDEN, client=client, device="cpu")
    load_dense_params(m, _WEIGHTS["w"])
    return m


def _trainer(client, mode="sync", cache_capacity=0, opt="adam", lr=1e-2):
    m = _model(client)
    o = (optimizer.Adam if opt == "adam" else optimizer.SGD)(
        learning_rate=lr, parameters=m.parameters())
    crit = nn.BCEWithLogitsLoss()
    return m, HeterPSTrainStep(m, lambda out, y: crit(out, y), o, mode=mode,
                               cache_capacity=cache_capacity)


def _jtrainer(jc, mode="sync", cache_capacity=0, lr=1e-2):
    jm, _ = _ref_weights(jc)
    o = jopt.Adam(learning_rate=lr, parameters=jm.parameters())
    crit = jnn.BCEWithLogitsLoss()
    return jm, JHeter(jm, lambda out, y: crit(out, y), o, mode=mode,
                      cache_capacity=cache_capacity)


def _run(step, data, prefetch=False):
    losses = []
    for i, batch in enumerate(data):
        losses.append(float(step(*batch)))
        if prefetch and i + 1 < len(data):
            step.prefetch(*data[i + 1])
    step.flush()
    return losses


def _jdata(data):
    """The same batches as the reference's tensors (one object each, so a
    prefetched batch is the one the step receives)."""
    return [tuple(paddle.to_tensor(t.numpy()) for t in b) for b in data]


def _rows(client, keys, tids=range(SLOTS + 1)):
    keys = np.asarray(keys, np.uint64)
    return {t: client.pull_sparse(t, keys).copy() for t in tids}


def _keys(data):
    return np.unique(np.concatenate([b[0].numpy().ravel() for b in data]))


def _check_against_reference(jstep, step, jc, pc, data, jl, pl):
    np.testing.assert_allclose(pl, jl, rtol=0, atol=ATOL)
    for k, v in step.params.items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   np.asarray(jstep.params[k]), rtol=0,
                                   atol=ATOL)
    ref, got = _rows(jc, _keys(data)), _rows(pc, _keys(data))
    for t in ref:
        np.testing.assert_allclose(got[t], ref[t], rtol=0, atol=ATOL)


def test_sync_step_matches_reference_sync_step(pair):
    jc, pc = pair
    data = _data(4)
    _, jstep = _jtrainer(jc)
    _, step = _trainer(pc)
    jl = _run(jstep, _jdata(data))
    pl = _run(step, data)
    jstep.close()
    step.close()
    _check_against_reference(jstep, step, jc, pc, data, jl, pl)


def test_pipelined_with_cache_matches_reference_once_all_hits(pair):
    """Both packages pipelined with a 64-row cache over two batches of ids
    in [0, 40) (every table's working set fits): the first pass misses,
    later passes are all hits, and losses, parameters and the rows written
    back by flush() agree."""
    jc, pc = pair
    data = _data(2, seed=5, vocab=40) * 3
    _, jstep = _jtrainer(jc, "pipelined", 64)
    _, step = _trainer(pc, "pipelined", 64)
    jl = _run(jstep, _jdata(data), prefetch=True)
    pl = []
    for i, batch in enumerate(data):
        pl.append(float(step(*batch)))
        if i == 1:
            misses = {t: c.stats["miss"] for t, c in step.caches.items()}
        if i + 1 < len(data):
            step.prefetch(*data[i + 1])
    assert {t: c.stats["miss"] for t, c in step.caches.items()} == misses
    hits = sum(c.stats["hit"] for c in step.caches.values())
    assert hits == sum(c.stats["device_gather"]
                       for c in step.caches.values()) > 0
    step.flush()
    jstep.close()
    step.close()
    _check_against_reference(jstep, step, jc, pc, data, jl, pl)


def test_sync_step_matches_port_eager_loop(ps):
    data = _data(4, seed=1)
    s2, c2 = _server()
    try:
        m = _model(c2)
        o = optimizer.Adam(learning_rate=1e-2, parameters=m.parameters())
        crit = nn.BCEWithLogitsLoss()
        eager = []
        for ids, dense, y in data:
            loss = crit(m(ids, dense), y)
            loss.backward()
            o.step()
            o.clear_grad()
            eager.append(loss.item())
        erows = _rows(c2, _keys(data))
    finally:
        c2.stop_servers()
        s2.stop()
    _, step = _trainer(ps)
    got = _run(step, data)
    step.close()
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
    for t, r in _rows(ps, _keys(data)).items():
        np.testing.assert_allclose(r, erows[t], rtol=0, atol=1e-6)


def test_deepfm_sync_step_matches_eager(ps):
    data = [(b[0],) + b[2:] for b in _data(3, seed=2)]
    gen = torch.Generator().manual_seed(0)

    def model(client):
        return DeepFM(num_slots=SLOTS, embedding_dim=DIM, hidden=HIDDEN,
                      client=client, device="cpu",
                      generator=gen.manual_seed(0))

    s2, c2 = _server()
    try:
        m = model(c2)
        o = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        eager = []
        for ids, y in data:
            loss = nn.BCEWithLogitsLoss()(m(ids), y)
            loss.backward()
            o.step()
            o.clear_grad()
            eager.append(loss.item())
    finally:
        c2.stop_servers()
        s2.stop()
    m = model(ps)
    o = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    step = HeterPSTrainStep(m, nn.BCEWithLogitsLoss(), o)
    got = _run(step, data)
    step.close()
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)


@pytest.mark.parametrize("prefetch", [False, True])
def test_bounded_staleness(ps, monkeypatch, prefetch):
    """A pull for step t observes every push through step t-2."""
    _, step = _trainer(ps, "pipelined")
    lock = threading.Lock()
    pushes_done = [0]
    pulls = []
    real_pull = HeterPSTrainStep._pull_round
    real_push = HeterPSTrainStep._push

    def rec_pull(pull_reqs):
        with lock:
            pulls.append(pushes_done[0])
        return real_pull(pull_reqs)

    def rec_push(self, grows, push_meta):
        real_push(self, grows, push_meta)
        with lock:
            pushes_done[0] += 1

    monkeypatch.setattr(HeterPSTrainStep, "_pull_round",
                        staticmethod(rec_pull))
    monkeypatch.setattr(HeterPSTrainStep, "_push", rec_push)
    data = _data(8, seed=7)
    _run(step, data, prefetch=prefetch)
    step.close()
    assert len(pulls) == len(data)
    for t, done in enumerate(pulls, start=1):
        assert t - 2 <= done <= t - 1, (t, done, pulls)


def test_prefetch_batch_mismatch_raises_and_numpy_batches_work(ps):
    _, step = _trainer(ps, "pipelined")
    data = _data(3)
    step(*data[0])
    step.prefetch(*data[1])
    with pytest.raises(RuntimeError, match="prefetch"):
        step(*data[2])
    rng = np.random.default_rng(11)
    raw = [(rng.integers(0, 50, (8, SLOTS)).astype(np.int64),
            rng.normal(size=(8, SLOTS)).astype(np.float32),
            np.ones((8, 1), np.float32)) for _ in range(3)]
    losses = _run(step, raw, prefetch=True)
    step.close()
    assert all(np.isfinite(losses))


def test_async_mode_flushes_the_pending_push(ps):
    _, step = _trainer(ps, "async")
    data = _data(3, seed=4)
    for b in data:
        step(*b)
    step._drain_fut()
    assert step._pending is not None
    grows, meta = step._pending
    emb0, uniq0 = meta[0]
    before = emb0.client.pull_sparse(emb0._table_cfg.table_id, uniq0).copy()
    g0 = grows.wait()[0][:uniq0.size]
    step.flush()
    assert step._pending is None
    after = emb0.client.pull_sparse(emb0._table_cfg.table_id, uniq0)
    np.testing.assert_allclose(after, before - 0.05 * g0, rtol=0, atol=1e-6)
    step.close()


def _sgd_run(cache_capacity, opt="sgd", partial_at=6):
    """Sync Wide&Deep (or a one-table model on a "sum" table) on a fresh
    server: losses, server rows after flush and cache stats."""
    s, c = _server()
    try:
        if opt == "sgd":
            model, step = _trainer(c, "sync", cache_capacity, opt="sgd",
                                   lr=5e-2)
            data = _data(8, seed=7, vocab=100, b=16, partial_at=partial_at)
            tids = range(SLOTS + 1)
        else:
            class M(nn.Layer):
                def __init__(self):
                    super().__init__("cpu")
                    self.e = SparseEmbedding(0, 4, optimizer="sum",
                                             client=c, device="cpu")
                    self.lin = nn.Linear(
                        4, 1, device="cpu",
                        generator=torch.Generator().manual_seed(0))

                def forward(self, ids):
                    return self.lin(self.e(ids))

            model = M()
            o = optimizer.SGD(learning_rate=0.1,
                              parameters=model.parameters())
            step = HeterPSTrainStep(
                model, lambda out, y: ((out - y) ** 2).mean(), o,
                cache_capacity=cache_capacity)
            rng = np.random.default_rng(2)
            data = [(torch.from_numpy(rng.integers(0, 20, 8)),
                     torch.from_numpy(
                         rng.normal(size=(8, 1)).astype(np.float32)))
                    for _ in range(4)]
            tids = (0,)
        losses = _run(step, data)
        stats = {t: dict(x.stats) for t, x in step.caches.items()}
        rows = _rows(c, np.arange(100), tids)
        step.close()
        return losses, rows, stats
    finally:
        c.stop_servers()
        s.stop()


@pytest.mark.parametrize("opt,capacity", [("sgd", 16), ("sum", 8)])
def test_eviction_writeback_equals_pushing_every_step(opt, capacity):
    ref_losses, ref_rows, _ = _sgd_run(0, opt)
    losses, rows, stats = _sgd_run(capacity, opt)
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=2e-4)
    assert any(s["eviction"] > 0 for s in stats.values()), stats
    assert any(s["writeback"] > 0 for s in stats.values()), stats
    for t in ref_rows:
        np.testing.assert_allclose(rows[t], ref_rows[t], rtol=0, atol=1e-4)


def test_hits_served_from_device(ps, monkeypatch):
    _, step = _trainer(ps, "sync", cache_capacity=256)
    data = _data(2, seed=5, vocab=100, b=16)
    step(*data[0])
    pulled = []
    orig = PSClient.pull_sparse

    def spy(self, table_id, keys, handles=None):
        pulled.append(np.asarray(keys).size)
        return orig(self, table_id, keys, handles)

    monkeypatch.setattr(PSClient, "pull_sparse", spy)
    gathered = sum(c.stats["device_gather"] for c in step.caches.values())
    step(*data[0])  # the same ids again: all hits
    assert sum(pulled) == 0, pulled
    assert sum(c.stats["device_gather"] for c in step.caches.values()) \
        - gathered == sum(np.unique(data[0][0][:, i]).size
                          for i in range(SLOTS)) + np.unique(data[0][0]).size
    step(*data[1])  # fresh ids: misses pull again
    assert sum(pulled) > 0
    step.close()


def test_non_sgd_table_skipped_with_warning(ps):
    class M(nn.Layer):
        def __init__(self):
            super().__init__("cpu")
            self.e = SparseEmbedding(0, 4, optimizer="adam", client=ps,
                                     device="cpu")
            self.lin = nn.Linear(4, 1, device="cpu")

        def forward(self, ids):
            return self.lin(self.e(ids))

    m = M()
    o = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    with pytest.warns(UserWarning, match="hot-row cache skipped"):
        step = HeterPSTrainStep(m, lambda out, y: ((out - y) ** 2).mean(),
                                o, cache_capacity=32)
    assert step.caches == {}
    ids = torch.arange(8)
    assert np.isfinite(float(step(ids, torch.ones(8, 1))))
    step.close()


def test_shared_table_two_calls_drops_cache(ps):
    class M(nn.Layer):
        def __init__(self):
            super().__init__("cpu")
            self.e = SparseEmbedding(0, 4, client=ps, device="cpu")
            self.lin = nn.Linear(8, 1, device="cpu")

        def forward(self, a, b):
            return self.lin(torch.cat([self.e(a), self.e(b)], dim=-1))

    m = M()
    o = optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    step = HeterPSTrainStep(m, lambda out, y: ((out - y) ** 2).mean(), o,
                            cache_capacity=32)
    assert 0 in step.caches
    a, b, y = torch.arange(8), torch.arange(8) + 4, torch.ones(8, 1)
    with pytest.warns(UserWarning, match="multiple embedding calls"):
        assert np.isfinite(float(step(a, b, y)))
    assert step.caches == {}
    assert np.isfinite(float(step(a, b, y)))
    step.close()


def test_injected_pull_fault_recovers(ps):
    _, step = _trainer(ps, "pipelined", cache_capacity=64)
    fault.configure("heter.pull", times=1, start=3)
    losses = _run(step, _data(6), prefetch=True)
    step.close()
    assert all(np.isfinite(losses))
    assert fault.default_injector().fired("heter.pull") == 1
    rec = metrics.default_registry().get("retry_recovered_total")
    assert rec.value(op="heter.pull") >= 1


def test_injected_push_fault_recovers(ps):
    _, step = _trainer(ps, "pipelined")
    fault.configure("heter.push", times=1, start=2)
    losses = _run(step, _data(5))
    step.close()
    assert all(np.isfinite(losses))
    assert fault.default_injector().fired("heter.push") == 1


def test_batch_shape_change_refreshes_the_plan(ps):
    _, step = _trainer(ps, opt="sgd", lr=0.1)
    rng = np.random.default_rng(5)
    for b in (32, 20, 32, 7):
        batch = (torch.from_numpy(rng.integers(0, 100, (b, SLOTS))),
                 torch.from_numpy(rng.normal(size=(b, SLOTS)).astype(
                     np.float32)), torch.ones(b, 1))
        ids, plan = step._route(batch)
        assert [p[1] for p in plan] == [(b,)] * SLOTS + [(b, SLOTS)]
        assert np.isfinite(float(step(*batch)))
    step.close()


def test_routing_computes_no_dense_value(ps):
    """The routing pass sees every id concretely and computes every float
    on ``meta``: nothing runs on a real device but the integer slicing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.real_floats = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.device.type != "meta":
                    self.real_floats.append(str(func))
            return out

    _, step = _trainer(ps)
    batch = _data(1)[0]
    with Spy() as spy:
        ids, plan = step._route(batch)
    assert spy.real_floats == []
    np.testing.assert_array_equal(ids[0], batch[0][:, 0].numpy())
    np.testing.assert_array_equal(ids[-1], batch[0].numpy())
    step.close()


class _CPUGraphs:
    """``StepGraphs``'s interface on the CPU: a key's first run's outputs
    are the graph's static outputs; a "replay" runs the step again on the
    static inputs and writes its results into those same tensors."""

    def __init__(self):
        self.graphs, self.replays = {}, {}
        self.captures = self.pool_bytes = 0

    def run(self, key, fn):
        out = fn()
        if key not in self.graphs:
            self.graphs[key] = (out[0].clone(),
                                tuple(g.clone() for g in out[1]))
            self.replays[key] = 0
            self.captures += 1
            return out
        loss, grows = self.graphs[key]
        loss.copy_(out[0])
        for s, g in zip(grows, out[1]):
            s.copy_(g)
        self.replays[key] += 1
        return loss, grows


@pytest.mark.parametrize("mode,cache", [("sync", 0), ("pipelined", 64)])
def test_graph_route_matches_uncaptured(mode, cache):
    data = _data(4, seed=3, vocab=60) * 2
    results = []
    for graphs in (None, _CPUGraphs()):
        s, c = _server()
        try:
            _, step = _trainer(c, mode, cache)
            step._graphs = graphs
            losses = _run(step, data, prefetch=mode == "pipelined")
            params = {k: v.detach().clone() for k, v in step.params.items()}
            rows = _rows(c, _keys(data))
            results.append((losses, params, rows, step.stats))
            step.close()
        finally:
            c.stop_servers()
            s.stop()
    (l0, p0, r0, _), (l1, p1, r1, st) = results
    np.testing.assert_allclose(l1, l0, rtol=0, atol=1e-6)
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), rtol=0,
                                   atol=1e-6)
    for t in r0:
        np.testing.assert_allclose(r1[t], r0[t], rtol=0, atol=1e-6)
    assert st["graph_captures"] >= 1
    assert sum(st["graph_replays"].values()) + st["graph_captures"] \
        == len(data)


def test_sync_to_layer_writes_the_step_params_back(ps):
    m, step = _trainer(ps)
    for b in _data(2):
        step(*b)
    assert not all(torch.equal(p, step.params[k])
                   for k, p in m.named_parameters())
    step.sync_to_layer()
    for k, p in m.named_parameters():
        assert torch.equal(p, step.params[k])
    step.close()
