"""The port's collectives, store and topology against the JAX package.

The reference is one controller over a mesh: rank r of its group is
device r, and an eager collective runs with shard r in the place of rank
r's tensor. The port runs one process a rank. One 4-rank gloo world
(``tests/torch_dist_workers.py``, started once for this module with a
time limit of its own) runs every collective on seeded inputs, rank r
holding row r of each global array; here the reference runs the same
collective on a 4-device mesh with that array sharded, and rank r's
result must equal the reference's shard r (fp32, rtol and atol 1e-6:
sums of four numbers in another order). A replicated input is the same
value on every rank, so ``all_reduce`` counts the ranks in both.
``send``/``recv`` (which the reference does not have) are held to its
``ppermute``; a group of some of the ranks (which the reference cannot
form) to numpy.
"""
import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu_torch import fault
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import topology as topo
from paddle_tpu_torch.distributed.store import TCPStore

import torch_dist_workers as workers

N = 4
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return workers.run_world("collective", N,
                             tmp_path_factory.mktemp("collective"))


@pytest.fixture(scope="module")
def ref():
    """The reference's results on a 4-device dp mesh, {case: global}."""
    inp = workers.collective_inputs(N)
    X = inp["x"]
    mesh = jtopo.build_mesh({"dp": N}, devices=jax.devices()[:N])
    jdist.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(
        mesh=mesh))
    jdist.destroy_process_group()
    g = jdist.new_group(axis_name="dp")

    def sharded(a):
        return paddle.to_tensor(jax.device_put(
            a, NamedSharding(mesh, P("dp"))))

    out = {}
    try:
        for name, op in (("sum", jdist.ReduceOp.SUM),
                         ("max", jdist.ReduceOp.MAX),
                         ("min", jdist.ReduceOp.MIN),
                         ("prod", jdist.ReduceOp.PROD),
                         ("avg", jdist.ReduceOp.AVG)):
            x = sharded(X)
            jdist.all_reduce(x, op=op, group=g)
            out[f"all_reduce_{name}"] = x.numpy()
        rep = paddle.to_tensor(np.full((4,), 2.0, np.float32))
        jdist.all_reduce(rep, group=g)
        out["all_reduce_replicated"] = rep.numpy()
        lst = []
        jdist.all_gather(lst, sharded(X), group=g)
        out["all_gather_list"] = np.stack([np.asarray(t) for t in lst])
        out["all_gather_stack"] = np.asarray(
            jdist.all_gather(None, sharded(X), group=g))
        out["all_gather_axis1"] = np.asarray(
            jdist.all_gather(None, sharded(X), group=g, axis=1))
        out["all_gather_object"] = jdist.all_gather_object([], {"v": 7}, g)
        b = sharded(X)
        jdist.broadcast(b, src=2, group=g)
        out["broadcast"] = b.numpy()
        red = sharded(X)
        jdist.reduce(red, dst=0, group=g)
        out["reduce"] = red.numpy()
        sc = sharded(np.zeros((N, 3, 2), np.float32))
        jdist.scatter(sc, [paddle.to_tensor(X[i]) for i in range(N)],
                      src=1, group=g)
        out["scatter"] = sc.numpy()
        rs = paddle.to_tensor(np.zeros(2 * N * 3, np.float32))
        jdist.reduce_scatter(rs, sharded(inp["rs"]), group=g)
        out["reduce_scatter"] = rs.numpy()
        out["alltoall"] = np.asarray(jdist.alltoall(
            sharded(inp["a2a"].reshape(N * N, 2)), group=g).numpy())
        out["ppermute_ring"] = np.asarray(jdist.ppermute(sharded(X), g))
        out["ppermute_pairs"] = np.asarray(jdist.ppermute(
            sharded(X), g, perm=[(0, 3), (3, 0), (1, 2)]))
        sb = jdist.shard_batch(inp["batch"], mesh=mesh)
        out["shard_batch"] = [np.asarray(s.data) for s in sorted(
            sb.addressable_shards, key=lambda s: s.device.id)]
        out["replicate"] = np.asarray(jdist.replicate(X[0], mesh=mesh))
        # dp 2 x mp 2: device (i, j) is rank 2i + j
        mesh2 = jtopo.build_mesh({"dp": 2, "mp": 2},
                                 devices=jax.devices()[:N])
        hcg = jtopo.HybridCommunicateGroup(mesh=mesh2)
        for name, grp in (("mp", hcg.get_model_parallel_group()),
                          ("dp", hcg.get_data_parallel_group())):
            x = paddle.to_tensor(jax.device_put(
                X.reshape(2, 2, 3, 2), NamedSharding(mesh2, P("dp", "mp"))))
            jdist.all_reduce(x, group=grp)
            out[f"hcg_{name}_all_reduce"] = x.numpy().reshape(N, 3, 2)
        sb = jdist.shard_batch(inp["batch"], mesh=mesh2)
        out["hcg_shard_batch"] = {s.device.id: np.asarray(s.data)
                                  for s in sb.addressable_shards}
    finally:
        jdist.set_hybrid_communicate_group(None)
        jdist.destroy_process_group()
    return out


def _rank_block(a, r, shape):
    """Shard r of the reference's global result, in rank r's shape."""
    return np.asarray(a).reshape((N,) + tuple(shape))[r]


REDUCES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
           "all_reduce_prod", "all_reduce_avg", "broadcast", "reduce",
           "ppermute_ring", "ppermute_pairs", "scatter", "reduce_scatter",
           "alltoall"]


@pytest.mark.parametrize("case", REDUCES)
def test_rank_r_holds_reference_shard_r(world, ref, case):
    for r, out in enumerate(world):
        got = out[case]
        np.testing.assert_allclose(got, _rank_block(ref[case], r, got.shape),
                                   err_msg=f"{case} rank {r}", **TOL)


def test_replicated_all_reduce_counts_ranks(world, ref):
    for out in world:
        np.testing.assert_allclose(out["all_reduce_replicated"],
                                   ref["all_reduce_replicated"], **TOL)
        np.testing.assert_allclose(out["all_reduce_replicated"],
                                   np.full(4, 2.0 * N))


def test_all_gather_forms_match_reference(world, ref):
    for out in world:
        np.testing.assert_allclose(out["all_gather_list"],
                                   ref["all_gather_list"], **TOL)
        np.testing.assert_allclose(out["all_gather_stack"],
                                   ref["all_gather_stack"], **TOL)
        assert out["all_gather_axis1"].shape == ref["all_gather_axis1"].shape
        np.testing.assert_allclose(out["all_gather_axis1"],
                                   ref["all_gather_axis1"], **TOL)
        assert out["all_gather_object"] == ref["all_gather_object"]
        assert out["all_gather_object_own"] == list(range(N))


def test_list_forms_agree_with_tensor_forms(world):
    for out in world:
        np.testing.assert_array_equal(out["reduce_scatter_list"],
                                      out["reduce_scatter"])
        np.testing.assert_array_equal(out["alltoall_list"], out["alltoall"])
        np.testing.assert_array_equal(out["alltoall_single"],
                                      out["alltoall"])


def test_send_recv_ring_is_reference_ppermute(world, ref):
    for r, out in enumerate(world):
        got = out["send_recv"]
        np.testing.assert_allclose(
            got, _rank_block(ref["ppermute_ring"], r, got.shape), **TOL)
        assert out["wait_is_identity"]


def test_shard_batch_and_replicate(world, ref):
    for r, out in enumerate(world):
        np.testing.assert_array_equal(out["shard_batch"],
                                      ref["shard_batch"][r])
        np.testing.assert_array_equal(out["shard_batch_np"],
                                      ref["shard_batch"][r])
        np.testing.assert_array_equal(out["replicate"][0], ref["replicate"])


def test_world_identity(world):
    for r, out in enumerate(world):
        assert (out["rank"], out["world"], out["env_rank"]) == (r, N, r)
        assert out["backend"] == "gloo"


def test_subgroup_of_some_ranks(world):
    X = workers.collective_inputs(N)["x"]
    for r, out in enumerate(world):
        assert out["g02"] == ({0: 0, 2: 1}.get(r, -1), 2)
        if r in (0, 2):
            np.testing.assert_allclose(out["g02_all_reduce"][0], X[0] + X[2],
                                       **TOL)
            np.testing.assert_array_equal(out["g02_broadcast"][0], X[2])


def test_hybrid_groups_match_reference(world, ref):
    topo_ = topo.CommunicateTopology(["dp", "mp"], [2, 2])
    for r, out in enumerate(world):
        h = out["hcg"]
        dp_i, mp_i = topo_.get_coord(r)
        assert h["mp_ranks"] == topo_.get_axis_list("dp", dp_i)
        assert h["dp_ranks"] == topo_.get_axis_list("mp", mp_i)
        assert (h["dp_rank"], h["mp_rank"]) == (dp_i, mp_i)
        assert h["mode"] == "model_parallel" and h["check"] == N
        assert out["axis_group_is_hcg"]
        for name in ("mp", "dp"):
            np.testing.assert_allclose(
                out[f"hcg_{name}_all_reduce"][0],
                ref[f"hcg_{name}_all_reduce"][r], **TOL)
        # shard_batch follows the dp axis: the rows of device r's dp slice
        np.testing.assert_array_equal(out["hcg_shard_batch"],
                                      ref["hcg_shard_batch"][r])


def test_deadline_guard_and_metrics(world):
    for r, out in enumerate(world):
        assert "did not complete" in out["timeout"]
        assert f"rank {r}" in out["timeout"]
        np.testing.assert_allclose(out["guarded_sum"],
                                   out["all_reduce_sum"])
        assert out["metric_families"] == [
            "collective_bytes_total", "collective_calls_total",
            "collective_seconds", "collective_timeout_total"]
        # the step diagnosis's "collective" term reads their seconds
        assert out["diag_collective_s"] > 0
        # launched collectives only: the faulted call launched nothing
        launches = out["launches"]
        assert launches["all_reduce"] == 10 + (r in (0, 2))
        assert launches["alltoall"] == 3 and launches["ppermute"] == 2


# ------------------------ one process: no world needed -----------------------


def test_communicate_topology_matches_reference():
    for mod in (topo, jtopo):
        t = mod.CommunicateTopology(["data", "pipe", "model"], [2, 2, 2])
        assert t.world_size() == 8
        assert t.get_hybrid_group_names() == ["dp", "pp", "mp"]
        assert t.get_dim("model") == 2
        assert t.get_rank(dp=1, pp=0, mp=1) == 5
        assert t.get_coord(5) == (1, 0, 1)
        assert t.get_axis_list("dp", 0) == [0, 1, 2, 3]
        comm = t.get_comm_list("mp")
        assert [0, 1] in comm and [6, 7] in comm and len(comm) == 4
        assert t.get_rank_from_stage(0, pp=1) == 2


@pytest.mark.parametrize("dims", [{"dp": 2, "mp": 2, "pp": 2}, {"mp": 2},
                                  {"sharding": 2, "sp": 2}, {}])
def test_build_mesh_axis_order_and_absorption(dims):
    want = jtopo.build_mesh(dims, devices=jax.devices()[:8])
    got = topo.build_mesh(dims, devices=range(8))
    assert got.axis_names == want.axis_names
    assert got.devices.shape == want.devices.shape
    # rank r sits where the reference's device r sits
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)


def test_hcg_from_the_env_contract(monkeypatch):
    """Before init_parallel_env a topology is arithmetic over the env's
    world (8 trainers here): the reference's HCG cases, groups without a
    process group, whose collectives raise."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "5")
    hcg = topo.HybridCommunicateGroup(dims={"dp": 2, "mp": 4})
    assert hcg.get_data_parallel_world_size() == 2
    assert hcg.get_model_parallel_world_size() == 4
    assert hcg.get_pipe_parallel_world_size() == 1
    assert hcg.get_model_parallel_group().nranks == 4
    assert hcg.get_parallel_mode() == "model_parallel"
    assert hcg.get_model_parallel_group().ranks == [4, 5, 6, 7]
    assert hcg.get_data_parallel_group().ranks == [1, 5]
    assert (hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()) \
        == (1, 1)
    import torch
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        C.all_reduce(torch.ones(2), group=hcg.get_model_parallel_group())


def test_gloo_refuses_a_cards_tensor_outside_all_reduce_and_broadcast(
        monkeypatch):
    import torch

    class CudaLike(torch.Tensor):
        is_cuda = True

    g = C.Group(None, ("world",), ranks=[0], pg=object(), backend="gloo")
    t = torch.ones(2).as_subclass(CudaLike)
    for kind in ("all_gather", "alltoall", "send", "scatter"):
        with pytest.raises(RuntimeError, match="gloo backend"):
            C._prepare(kind, g, t)
    for kind in ("all_reduce", "broadcast"):
        assert C._prepare(kind, g, t) is g


def test_split_raises_naming_tensor_parallel():
    with pytest.raises(NotImplementedError, match="A11"):
        C.split(None, (4, 4), "linear")


def test_store_surface_retry_and_fault_sites(monkeypatch):
    from paddle_tpu_torch.fault import RetryPolicy
    master = TCPStore("127.0.0.1", 0, is_master=True)
    assert master.port > 0
    client = TCPStore("127.0.0.1", master.port,
                      retry=RetryPolicy(max_attempts=2, base_delay=0.0))
    client.set("k", "v")
    assert master.get("k") == b"v"
    assert client.add("n", 2) == 2 and master.add("n", 3) == 5
    assert client.check("k") and not client.check("missing")
    client.wait(["k"])
    client.delete_key("k")
    assert not master.check("k")
    fault.reset()
    try:
        # one injected failure is retried away; two exhaust the policy
        fault.configure("store.set", times=1)
        client.set("a", "1")
        assert fault.default_injector().fired("store.set") == 1
        fault.configure("store.get", times=2)
        with pytest.raises(Exception, match="store.get"):
            client.get("a")
    finally:
        fault.reset()
    master.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        master.get("a")
