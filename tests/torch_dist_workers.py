"""Multi-process worlds of the port's data-parallel tests.

    python tests/torch_dist_workers.py SCENARIO NPROCS OUTDIR

starts NPROCS ranks with ``paddle_tpu_torch.distributed.spawn`` (gloo on
the CPU), runs one scenario in each, and writes rank r's results to
``OUTDIR/SCENARIO.r.pt``. It imports only the port (a spawned child
re-imports this module): the tests hold the results against the JAX
package in their own process. Inputs come from ``OUTDIR/inputs.npz``
(written by the test) or from a seed.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    import torch
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def collective_inputs(n):
    """The seeded global arrays: rank r holds row r of each."""
    rng = np.random.default_rng(0)
    return dict(
        x=rng.standard_normal((n, 3, 2)).astype(np.float32),
        rs=rng.standard_normal((n, 2 * n, 3)).astype(np.float32),
        a2a=rng.standard_normal((n, n, 2)).astype(np.float32),
        batch=rng.standard_normal((2 * n, 5)).astype(np.float32))


def collective(outdir):
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.profiler import metrics, monitor

    dist.init_parallel_env(device="cpu")
    begin = monitor.diag_signals()
    r, n = dist.get_rank(), dist.get_world_size()
    inp = collective_inputs(n)
    X = inp["x"]
    out = {"rank": r, "world": n, "backend": dist.get_backend(),
           "env_rank": dist.ParallelEnv().rank}
    C.reset_launch_stats()
    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("prod", dist.ReduceOp.PROD),
                     ("avg", dist.ReduceOp.AVG)):
        x = _t(X[r:r + 1])
        assert dist.all_reduce(x, op=op) is x
        out[f"all_reduce_{name}"] = _np(x)
    rep = torch.full((4,), 2.0)
    dist.all_reduce(rep)
    out["all_reduce_replicated"] = _np(rep)
    lst = []
    dist.all_gather(lst, _t(X[r:r + 1]))
    out["all_gather_list"] = np.stack([_np(t) for t in lst])
    out["all_gather_stack"] = _np(dist.all_gather(None, _t(X[r:r + 1])))
    out["all_gather_axis1"] = _np(dist.all_gather(None, _t(X[r:r + 1]),
                                                  axis=1))
    objs = []
    dist.all_gather_object(objs, {"v": 7})  # the same object on every rank
    out["all_gather_object"] = objs
    objs = []
    dist.all_gather_object(objs, r)  # each rank's own
    out["all_gather_object_own"] = objs
    b = _t(X[r:r + 1])
    dist.broadcast(b, src=2)
    out["broadcast"] = _np(b)
    red = _t(X[r:r + 1])
    dist.reduce(red, dst=0)
    out["reduce"] = _np(red)
    sc = torch.zeros(3, 2)
    dist.scatter(sc, [_t(X[i]) for i in range(n)] if r == 1 else None,
                 src=1)
    out["scatter"] = _np(sc)
    rs = torch.zeros(2, 3)
    dist.reduce_scatter(rs, _t(inp["rs"][r]))
    out["reduce_scatter"] = _np(rs)
    rsl = torch.zeros(2, 3)
    dist.reduce_scatter(rsl, list(_t(inp["rs"][r]).split(2)))
    out["reduce_scatter_list"] = _np(rsl)
    out["alltoall"] = _np(dist.alltoall(_t(inp["a2a"][r])))
    outs = []
    dist.alltoall([_t(c) for c in inp["a2a"][r]], outs)
    out["alltoall_list"] = np.stack([_np(t) for t in outs])
    out["alltoall_single"] = _np(dist.alltoall_single(_t(inp["a2a"][r])))
    out["ppermute_ring"] = _np(dist.ppermute(_t(X[r:r + 1])))
    out["ppermute_pairs"] = _np(dist.ppermute(_t(X[r:r + 1]),
                                              perm=[(0, 3), (3, 0), (1, 2)]))
    # send/recv around the ring, even ranks first
    got = torch.zeros(1, 3, 2)
    nxt, prv = (r + 1) % n, (r - 1) % n
    if r % 2 == 0:
        dist.send(_t(X[r:r + 1]), dst=nxt)
        dist.recv(got, src=prv)
    else:
        dist.recv(got, src=prv)
        dist.send(_t(X[r:r + 1]), dst=nxt)
    out["send_recv"] = _np(got)
    dist.barrier()
    out["wait_is_identity"] = dist.wait(got) is got
    out["shard_batch"] = _np(dist.shard_batch(_t(inp["batch"])))
    out["shard_batch_np"] = dist.shard_batch(inp["batch"])
    repl = _t(X[r:r + 1])
    dist.replicate(repl)
    out["replicate"] = _np(repl)
    # a group over ranks 0 and 2: every rank creates it, members reduce
    g02 = dist.new_group([0, 2])
    out["g02"] = (g02.rank, g02.nranks)
    if r in (0, 2):
        x = _t(X[r:r + 1])
        dist.all_reduce(x, group=g02)
        out["g02_all_reduce"] = _np(x)
        x = _t(X[r:r + 1])
        dist.broadcast(x, src=1, group=g02)  # group rank 1 = rank 2
        out["g02_broadcast"] = _np(x)
    # the hybrid topology over this world: dp 2 x mp 2
    hcg = dist.HybridCommunicateGroup(dims={"dp": 2, "mp": 2})
    dist.set_hybrid_communicate_group(hcg)
    mp, dp = hcg.get_model_parallel_group(), hcg.get_data_parallel_group()
    out["hcg"] = dict(mp_ranks=mp.ranks, dp_ranks=dp.ranks,
                      mp_rank=hcg.get_model_parallel_rank(),
                      dp_rank=hcg.get_data_parallel_rank(),
                      mode=hcg.get_parallel_mode(),
                      check=hcg.get_check_parallel_group().nranks)
    for name, g in (("mp", mp), ("dp", dp)):
        x = _t(X[r:r + 1])
        dist.all_reduce(x, group=g)
        out[f"hcg_{name}_all_reduce"] = _np(x)
    out["hcg_shard_batch"] = _np(dist.shard_batch(_t(inp["batch"])))
    axis_g = dist.new_group(axis_name="mp")
    out["axis_group_is_hcg"] = axis_g is mp
    dist.set_hybrid_communicate_group(None)
    # the deadline guard's fault site: every rank raises before launching
    metrics.set_enabled(True)
    fault.configure("collective.timeout", times=1)
    try:
        dist.all_reduce(_t(X[r:r + 1]))
        out["timeout"] = "no error"
    except dist.CollectiveTimeoutError as e:
        out["timeout"] = str(e)
    fault.reset()
    # and a real deadline: it covers launch and completion
    os.environ["PADDLE_TPU_COLLECTIVE_TIMEOUT"] = "30"
    x = _t(X[r:r + 1])
    dist.all_reduce(x)
    out["guarded_sum"] = _np(x)
    del os.environ["PADDLE_TPU_COLLECTIVE_TIMEOUT"]
    snap = metrics.default_registry().snapshot()
    out["metric_families"] = sorted(
        k for k in snap if k.startswith("collective"))
    out["launches"] = C.launch_stats()
    out["diag_collective_s"] = (monitor.diag_signals()["collective"]
                                - begin["collective"])
    torch.save(out, os.path.join(outdir, f"collective.{r}.pt"))
    dist.destroy_process_group()


def _linear(inp, prefix):
    import torch
    from paddle_tpu_torch import nn
    net = nn.Linear(16, 4, device="cpu")
    with torch.no_grad():
        net.weight.copy_(_t(inp[prefix + "w"]))
        net.bias.copy_(_t(inp[prefix + "b"]))
    return net


def _eager(inp, prefix, make_opt, steps, labels_key):
    """Eager DataParallel steps of the Linear classifier on this rank's
    rows: (losses, weight, bias)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.nn import functional as F
    dp = dist.DataParallel(_linear(inp, prefix))
    opt = make_opt(dp.parameters())
    xb = dist.shard_batch(_t(inp["X"]))
    yb = dist.shard_batch(_t(inp[labels_key]).long())
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(dp(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, _np(dp._layers.weight), _np(dp._layers.bias)


def data_parallel(outdir):
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils.convert import load_numpy_params

    dist.init_parallel_env(device="cpu")
    r = dist.get_rank()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    # wrapping broadcasts rank 0's parameters: rank 1 starts elsewhere
    seeded = _linear(inp, "")
    if r == 1:
        with torch.no_grad():
            seeded.weight.add_(1.0)
    dp = dist.DataParallel(seeded)
    out["broadcast_weight"] = _np(seeded.weight)
    out["names"] = [k for k, _ in dp.named_parameters()]
    out["state_keys"] = sorted(dp.state_dict())
    out["delegates"] = dp.weight is seeded.weight
    out["sgd"] = _eager(inp, "", lambda ps: optimizer.SGD(
        learning_rate=0.1, parameters=ps), 1, "Y")
    out["adamw"] = _eager(inp, "", lambda ps: optimizer.AdamW(
        learning_rate=0.01, parameters=ps, weight_decay=0.01), 3, "Y")
    # labels ignored unevenly: rank 0's rows are mostly -100
    out["uneven"] = _eager(inp, "", lambda ps: optimizer.SGD(
        learning_rate=0.1, parameters=ps), 1, "Yu")
    # a parameter the loss never reaches
    net = _linear(inp, "")
    net.extra = nn.Linear(4, 4, device="cpu")
    dpu = dist.DataParallel(net)
    try:
        F.cross_entropy(dpu(dist.shard_batch(_t(inp["X"]))),
                        dist.shard_batch(_t(inp["Y"]).long())).backward()
        out["unused"] = "no error"
    except RuntimeError as e:
        out["unused"] = str(e)
    # TrainStep over DataParallel(GPT tiny): this rank's rows of the batch
    params = {k[len("gpt."):]: v for k, v in inp.items()
              if k.startswith("gpt.")}
    for tag, lab_key in (("step", "labels"), ("step_uneven", "labels_u")):
        model = GPT(GPTConfig.tiny(), device="cpu")
        load_numpy_params(model, params)
        step = jit.TrainStep(dist.DataParallel(model), F.cross_entropy,
                             optimizer.AdamW(learning_rate=1e-3,
                                             parameters=model.parameters(),
                                             weight_decay=0.01))
        C.reset_launch_stats()
        losses = []
        for s in range(2):
            ids = dist.shard_batch(_t(inp[f"ids{s}"]).long())
            lab = dist.shard_batch(_t(inp[f"{lab_key}{s}"]).long())
            losses.append(float(step(ids, lab)))
        out[tag] = dict(
            losses=losses, launches=C.launch_stats(),
            params={k: _np(v) for k, v in step.params.items()},
            slots={k: {s: _np(v) for s, v in d.items()}
                   for k, d in step.opt_state.items()})
    torch.save(out, os.path.join(outdir, f"dp.{r}.pt"))
    dist.destroy_process_group()


#: the batch-norm routes of the synchronized-BN world, and the rows of the
#: global batch of 4 each rank takes
BN_ROUTES = ("unfused", "fused", "fused_add", "conv1x1", "sync", "composed")
BN_SPLITS = {"even": ((0, 2), (2, 4)), "uneven": ((0, 3), (3, 4))}
BN_C = 8  # channels (and classes of the per-pixel loss)


def bn_layer(route):
    """The port's layer of one batch-norm route (NHWC, 8 channels): the
    unfused BatchNorm2D, the fused BN+ReLU (with the residual add for
    "fused_add"; fp64 inputs on the card's composed route for
    "composed"), the 1x1 conv + BN chain, SyncBatchNorm."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import resnet
    df = dict(data_format="NHWC", device="cpu")
    if route in ("unfused", "sync"):
        cls = nn.SyncBatchNorm if route == "sync" else nn.BatchNorm2D
        return cls(BN_C, **df)
    if route != "conv1x1":
        return nn.BatchNorm2D(BN_C, act="relu", **df)

    class Chain(nn.Layer):
        def __init__(self):
            super().__init__("cpu")
            self.conv = nn.Conv2D(2 * BN_C, BN_C, 1, bias_attr=False, **df)
            self.bn = nn.BatchNorm2D(BN_C, act="relu", **df)

        def forward(self, x):
            return resnet._conv_bn(self.conv, self.bn, x)

    return Chain()


def tiny_resnet(fused=True):
    """A small NHWC bottleneck ResNet on the CPU: a 3x3 stem to 32
    channels with its BN+ReLU, bottlenecks (32, 8), (32, 16, stride 2, a
    downsample) and (64, 16), pooling and a Linear(64, 10); its 1x1 convs
    take the fused chain. 11 batch norms."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.resnet import BottleneckBlock
    from paddle_tpu_torch.nn import functional as F
    df = dict(data_format="NHWC", device="cpu")
    norm = None if fused else nn.BatchNorm2D

    class Tiny(nn.Layer):
        def __init__(self):
            super().__init__("cpu")
            self.conv1 = nn.Conv2D(3, 32, 3, padding=1, bias_attr=False,
                                   **df)
            self.bn1 = nn.BatchNorm2D(32, act="relu", **df)
            self.block1 = BottleneckBlock(32, 8, norm_layer=norm, **df)
            self.block2 = BottleneckBlock(32, 16, 2, nn.Sequential(
                nn.Conv2D(32, 64, 1, stride=2, bias_attr=False, **df),
                nn.BatchNorm2D(64, **df)), norm_layer=norm, **df)
            self.block3 = BottleneckBlock(64, 16, norm_layer=norm, **df)
            self.pool = nn.AdaptiveAvgPool2D(1, data_format="NHWC")
            self.fc = nn.Linear(64, 10, device="cpu")

        def forward(self, x):
            x = self.bn1(self.conv1(x))
            x = self.block3(self.block2(self.block1(x)))
            return self.fc(F.flatten(self.pool(x), 1))

    return Tiny()


def _prefixed(inp, pre):
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


def _bn_case(inp, route, rows):
    """One DataParallel forward and backward of a route's layer on this
    rank's rows: the per-pixel cross-entropy's global loss, the output,
    the input's (and residual's) gradient, the parameters' reduced
    gradients, the running statistics, and the collectives and
    compositions counted."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import fused_bn
    from paddle_tpu_torch.utils.convert import load_numpy_params
    layer = bn_layer(route)
    load_numpy_params(layer, _prefixed(inp, f"{route}.p."))
    dp = dist.DataParallel(layer)
    dt = torch.float64 if route == "composed" else torch.float32
    lo, hi = rows
    x = _t(inp[f"{route}.x"][lo:hi]).to(dt).requires_grad_(True)
    args = [x]
    if route == "fused_add":
        args.append(_t(inp[f"{route}.z"][lo:hi]).requires_grad_(True))
    lab = _t(inp[f"{route}.lab"][lo:hi]).long().reshape(-1)
    C.reset_launch_stats()
    kernels.reset_stats()
    use_kernel = fused_bn.use_kernel
    if route == "composed":  # the card's route for a type the kernel refuses
        fused_bn.use_kernel = lambda *a: True
    try:
        out = dp(*args)
        loss = F.cross_entropy(out.reshape(-1, BN_C), lab)
        loss.backward()
    finally:
        fused_bn.use_kernel = use_kernel
    return dict(loss=float(loss), out=_np(out), dx=_np(x.grad),
                dz=_np(args[1].grad) if len(args) > 1 else None,
                grads={k: _np(p.grad) for k, p in layer.named_parameters()},
                buffers={k: _np(b) for k, b in layer.named_buffers()},
                launches=C.launch_stats(), stats=kernels.all_stats(),
                composed=kernels.composed_stats())


def resnet_dp(outdir):
    """Synchronized batch norm over a 2-rank gloo world: each route's
    layer on even and uneven shards of a global batch of 4; one Momentum
    step of the tiny ResNet (2 images a rank) through the eager
    DataParallel loop and through TrainStep(DataParallel); ResNet-50's
    launches and collectives under the group, fused and unfused."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.utils.convert import load_numpy_params

    dist.init_parallel_env(device="cpu")
    r = dist.get_rank()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {}
    for route in BN_ROUTES:
        for split, rows in BN_SPLITS.items():
            out[f"{route}.{split}"] = _bn_case(inp, route, rows[r])
    # the tiny ResNet: one Momentum(0.1, 0.9) step each way
    xs = dist.shard_batch(_t(inp["tiny.x"]))
    ys = dist.shard_batch(_t(inp["tiny.y"]).long())
    weights = _prefixed(inp, "tiny.p.")
    model = tiny_resnet()
    load_numpy_params(model, weights)
    dp = dist.DataParallel(model)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=dp.parameters())
    C.reset_launch_stats()
    loss = F.cross_entropy(dp(xs), ys)
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["tiny.eager"] = dict(
        loss=float(loss), launches=C.launch_stats(),
        buckets=len(dp._reducer.buckets),
        params={k: _np(p) for k, p in model.named_parameters()},
        buffers={k: _np(b) for k, b in model.named_buffers()})
    # the same step with a parameter the loss never reaches: its bucket
    # goes out at the backward's end, after every batch norm's all-reduce
    model = tiny_resnet()
    load_numpy_params(model, weights)
    model.extra = torch.nn.Parameter(torch.zeros(3))
    dp = dist.DataParallel(model, find_unused_parameters=True)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=dp.parameters())
    loss = F.cross_entropy(dp(xs), ys)
    loss.backward()
    opt.step()
    out["tiny.unused"] = dict(
        loss=float(loss),
        params={k: _np(p) for k, p in model.named_parameters()
                if k != "extra"},
        buffers={k: _np(b) for k, b in model.named_buffers()})
    model = tiny_resnet()
    load_numpy_params(model, weights)
    step = jit.TrainStep(dist.DataParallel(model), F.cross_entropy,
                         optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                            parameters=model.parameters()))
    C.reset_launch_stats()
    kernels.reset_stats()
    loss = step(xs, ys)
    out["tiny.step"] = dict(
        loss=float(loss), launches=C.launch_stats(),
        stats=kernels.all_stats(), buckets=len(step._buckets),
        params={k: _np(v) for k, v in step.params.items()},
        buffers={k: _np(v) for k, v in step.buffers.items()})
    # ResNet-50 NHWC under the group, its defaults and fused_bn=False
    imgs = dist.shard_batch(_t(inp["rn50.x"]))
    labels = dist.shard_batch(_t(inp["rn50.y"]).long())
    for tag, fused in (("rn50.fused", True), ("rn50.unfused", False)):
        net = resnet50(num_classes=10, data_format="NHWC", fused_bn=fused,
                       device="cpu",
                       generator=torch.Generator().manual_seed(0))
        dpn = dist.DataParallel(net)
        C.reset_launch_stats()
        kernels.reset_stats()
        loss = F.cross_entropy(dpn(imgs), labels)
        loss.backward()
        out[tag] = dict(
            loss=float(loss), launches=C.launch_stats(),
            stats=kernels.all_stats(),
            buffers={k: _np(b) for k, b in net.named_buffers()},
            grads={k: _np(p.grad) for k, p in net.named_parameters()})
    torch.save(out, os.path.join(outdir, f"resnet_dp.{r}.pt"))
    dist.destroy_process_group()


ZERO_LEVELS = ("os", "os_g", "p_g_os")


def zero_net(inp):
    """The reference test's Net (d 16): three Linears, ReLU between."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class Net(nn.Layer):
        def __init__(self):
            super().__init__(device="cpu")
            self.fc1 = nn.Linear(16, 32, device="cpu")
            self.fc2 = nn.Linear(32, 32, device="cpu")
            self.fc3 = nn.Linear(32, 16, device="cpu")
            self.name_parameters()

        def forward(self, x):
            return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))

    net = Net()
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(_t(inp["net." + k]))
    return net


def zero_gpt(inp):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.utils.convert import load_numpy_params
    model = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(model, {k[len("gpt."):]: v for k, v in inp.items()
                              if k.startswith("gpt.")})
    return model


def _zero_record(model, opt, losses):
    """What a rank holds after a run: the losses, the whole parameters
    (``state_dict`` gathers them at stage 3), each slot's shard and the
    dimension it was cut along, and at stage 3 each parameter's shard."""
    lay = opt.layout
    names = {id(p): k for k, p in model.named_parameters()}
    slots, dims, shards = {}, {}, {}
    for p in opt._opt._parameter_list:
        k = names[id(p)]
        dims[k] = lay.entries[opt._names[id(p)]].dim
        slots[k] = {s: _np(v) for s, v in
                    (opt._opt._slots.get(id(p)) or {}).items()}
        shards[k] = _np(p)
    return dict(losses=losses, slots=slots, dims=dims, shards=shards,
                params={k: _np(v) for k, v in model.state_dict().items()},
                launches=None)


def zero(outdir):
    """ZeRO over this gloo world at every level: the reference test's Net
    with Adam on the same batch everywhere, GPT tiny with AdamW on this
    rank's rows, eagerly (and at world 2 inside jit.TrainStep with the
    health sentinel), 4 steps; at world 2 also save_group_sharded_model
    and the raises."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.nn import functional as F

    dist.init_parallel_env(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {"rank": r, "world": n}
    X, Y = _t(inp["X"]), _t(inp["Y"])
    ids = [dist.shard_batch(_t(inp[f"ids{s}"]).long()) for s in range(4)]
    lab = [dist.shard_batch(_t(inp[f"labels{s}"]).long()) for s in range(4)]
    for level in ZERO_LEVELS:
        topology.set_hybrid_communicate_group(None)
        net = zero_net(inp)
        net, opt, _ = group_sharded_parallel(
            net, optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters()), level)
        C.reset_launch_stats()
        losses = []
        for _ in range(4):
            loss = torch.nn.functional.mse_loss(net(X), Y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        launches = C.launch_stats()
        out[("net", level)] = _zero_record(net, opt, losses)
        out[("net", level)]["launches"] = launches
        if n == 2 and level == "p_g_os":
            save_group_sharded_model(net, os.path.join(outdir, "saved"),
                                     opt)
        topology.set_hybrid_communicate_group(None)
        gpt = zero_gpt(inp)
        gpt, opt, _ = group_sharded_parallel(
            gpt, optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=gpt.parameters()), level)
        losses = []
        for s in range(4):
            loss = F.cross_entropy(gpt(ids[s]), lab[s])
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        out[("gpt", level)] = _zero_record(gpt, opt, losses)
        if n == 2:
            topology.set_hybrid_communicate_group(None)
            gpt = zero_gpt(inp)
            gpt, opt, _ = group_sharded_parallel(
                gpt, optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                     parameters=gpt.parameters()), level)
            os.environ["PADDLE_TPU_HEALTH_INTERVAL"] = "1"
            step = jit.TrainStep(gpt, F.cross_entropy, opt, health=True)
            C.reset_launch_stats()
            losses = [float(step(ids[s], lab[s])) for s in range(4)]
            launches = C.launch_stats()
            health = dict(step.last_health)
            step.sync_to_layer()
            rec = _zero_record(gpt, opt, losses)
            rec["slots"] = {k: {s: _np(v) for s, v in d.items()}
                            for k, d in step.opt_state.items()}
            rec["launches"] = launches
            rec["health"] = health
            rec["state_dict_slots"] = [
                a.shape for a in step.state_dict()["opt_flat"]]
            out[("step", level)] = rec
    topology.set_hybrid_communicate_group(None)
    errors = {}
    for name, kw in (("level", dict(level="zero")),
                     ("offload", dict(level="os", offload=True)),
                     ("buffer", dict(level="os", buffer_max_size=4)),
                     ("kwargs", dict(level="os", foo=1))):
        net = zero_net(inp)
        try:
            group_sharded_parallel(net, optimizer.Adam(
                parameters=net.parameters()), **kw)
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = type(e).__name__
    topology.set_hybrid_communicate_group(
        topology.HybridCommunicateGroup(dims={"dp": n}))
    net = zero_net(inp)
    try:
        group_sharded_parallel(net, optimizer.Adam(
            parameters=net.parameters()), "os")
        errors["no_axis"] = None
    except ValueError as e:
        errors["no_axis"] = str(e)
    out["errors"] = errors
    torch.save(out, os.path.join(outdir, f"zero.{r}.pt"))
    dist.destroy_process_group()


def _zero_stage1(inp):
    """GPT tiny with AdamW through group_sharded_parallel at "os"."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    topology.set_hybrid_communicate_group(None)
    gpt = zero_gpt(inp)
    gpt, opt, _ = group_sharded_parallel(
        gpt, optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                             parameters=gpt.parameters()), "os")
    return gpt, opt


def _zero_train(gpt, opt, inp, steps):
    """Eager steps on the same global batch on every rank (each rank's
    gradient is then the group's mean bit for bit, at any world size)."""
    from paddle_tpu_torch.nn import functional as F
    losses = []
    for s in steps:
        loss = F.cross_entropy(gpt(_t(inp[f"ids{s}"]).long()),
                               _t(inp[f"labels{s}"]).long())
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _zero_gathered(gpt, opt):
    """The whole state: parameters and the optimizer's state dict (every
    rank gathers its slots)."""
    return dict(params={k: _np(v) for k, v in gpt.state_dict().items()},
                opt={k: (_np(v) if hasattr(v, "shape") else v)
                     for k, v in opt.state_dict().items()})


def _zero_ckpt_state(gpt, opt):
    """What the sharded checkpoint holds: the parameters (whole on every
    rank at stage 1: written once) and each rank's slot shards."""
    return {"model": {k: v.detach() for k, v in gpt.state_dict().items()},
            "opt": opt.sharded_state_dict()}


def _zero_restore(outdir, ckdir, inp, coordinated):
    """Restore a sharded step onto this world, then one more step."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    gpt, opt = _zero_stage1(inp)
    coord = ckpt.coordinator_from_env(timeout=60) if coordinated else None
    mgr = ckpt.open_manager(ckdir, layout="sharded", mesh=opt.group,
                            coordinator=coord)
    state, step = mgr.load_latest()
    gpt.load_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    return dict(step=step, restored=_zero_gathered(gpt, opt),
                next_loss=_zero_train(gpt, opt, inp, [2]),
                after=_zero_gathered(gpt, opt))


def _zero_save(outdir, ckdir, inp, coordinated):
    """Two steps, the state gathered, a sharded save, one more step."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    gpt, opt = _zero_stage1(inp)
    losses = _zero_train(gpt, opt, inp, [0, 1])
    coord = ckpt.coordinator_from_env(timeout=60) if coordinated else None
    mgr = ckpt.open_manager(ckdir, layout="sharded", coordinator=coord)
    saved = _zero_gathered(gpt, opt)
    committed = mgr.save(_zero_ckpt_state(gpt, opt), 2)
    files = sorted(os.listdir(mgr.path_for(2)))
    return dict(losses=losses, committed=committed, saved=saved,
                files=files, next_loss=_zero_train(gpt, opt, inp, [2]),
                after=_zero_gathered(gpt, opt))


def zero_ckpt(outdir):
    """A stage-1 world saved through the sharded checkpoint and restored
    onto another world size: a world of 2 saves into ``ck2`` (through
    the coordinator) and restores ``ck1``; a world of 1 restores ``ck2``
    and saves ``ck1`` (the test runs 2, 1, 2 in turn)."""
    import torch
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    ck1, ck2 = (os.path.join(outdir, d) for d in ("ck1", "ck2"))
    out = {"rank": r, "world": n}
    if n == 1:
        out["restore"] = _zero_restore(outdir, ck2, inp, False)
        out["save"] = _zero_save(outdir, ck1, inp, False)
    elif os.path.isdir(ck1):
        out["restore"] = _zero_restore(outdir, ck1, inp, True)
    else:
        out["save"] = _zero_save(outdir, ck2, inp, True)
    torch.save(out, os.path.join(outdir, f"zero_ckpt.{r}.pt"))
    dist.barrier()
    dist.destroy_process_group()


PP_STEPS = 3


def pp_gpt(inp, prefix="gpt.", cfg=None):
    """GPT (tiny unless ``cfg``) with the reference's weights."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.utils.convert import load_numpy_params
    model = GPT(cfg or GPTConfig.tiny(), device="cpu")
    load_numpy_params(model, {k[len(prefix):]: v for k, v in inp.items()
                              if k.startswith(prefix)})
    return model


def pp_g5_config():
    """The 5-layer GPT the world of 4 splits over pp 4 ([2, 1, 1, 1])."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=64, hidden_size=16, num_layers=5,
                     num_heads=2, max_position_embeddings=32, dropout=0.0,
                     attn_dropout=0.0)


def _pp_topology(dims):
    from paddle_tpu_torch.distributed import topology
    topology.set_hybrid_communicate_group(None)
    hcg = topology.HybridCommunicateGroup(dims=dims)
    topology.set_hybrid_communicate_group(hcg)
    return hcg


def _pp_run(step, inp, prefix, steps):
    """``steps`` calls of a pipeline step on the global batches; the
    losses, each step's kernel counters (plain on the CPU), the
    collectives and transfers of the last one, and the peak in flight."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import kernels
    losses, launches = [], []
    for s in range(steps):
        kernels.reset_stats()
        C.reset_launch_stats()
        loss = step(_t(inp[f"{prefix}ids{s}"]).long(),
                    _t(inp[f"{prefix}labels{s}"]).long())
        losses.append(float(loss))
        launches.append({k: v for k, v in kernels.all_stats().items()
                         if v["kernel"] or v["plain"]})
    return dict(losses=losses, launches=launches,
                collectives=C.launch_stats(),
                transfers=dict(step.last_transfers),
                peak=step.peak_in_flight, stage=step.stage,
                counts=list(step.run.counts))


def _pp_params(model):
    return {k: _np(v) for k, v in model.named_parameters()}


def pp_poison_layer():
    """A PipelineLayer of four Linear + scale blocks whose scale's
    gradient is inf on the ranks that set ``pp_poison_layer.armed``."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.meta_parallel import PipelineLayer

    class _Inf(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            return x * w

        @staticmethod
        def backward(ctx, dy):
            dw = torch.full((), float("inf") if pp_poison_layer.armed
                            else 0.0, dtype=dy.dtype)
            return dy, dw

    class Block(nn.Layer):
        def __init__(self):
            super().__init__(device="cpu")
            self.fc = nn.Linear(16, 16, device="cpu")
            self.scale = torch.nn.Parameter(torch.ones(()))

        def forward(self, x):
            return _Inf.apply(self.fc(x), self.scale.to(x.dtype))

    torch.manual_seed(0)
    return PipelineLayer([Block() for _ in range(4)], num_stages=2,
                         loss_fn=lambda out, y: ((out.float() - y) ** 2)
                         .mean())


pp_poison_layer.armed = False


def pipeline(outdir):
    """The pipeline over this gloo world. World 2 (pp 2): GPT tiny with
    Adam(1e-2), M 2, 3 steps with the sentinel on; PipelineParallel.
    train_batch on a PipelineLayer (Embedding + 5 Linear, "layer:Linear",
    MSE, SGD 0.05, 5 steps); the 1F1B bound at M 16; fp16 with an inf on
    stage 1; O2 bf16. World 4: GPT tiny over pp 2 x dp 2 as above, then
    the 5-layer GPT over pp 4, M 4, 3 steps."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel,
        PipelineParallelTrainStep)
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.utils.convert import load_numpy_params

    dist.init_parallel_env(device="cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    inp = dict(np.load(os.path.join(outdir, "inputs.npz")))
    out = {"rank": r, "world": n}
    os.environ["PADDLE_TPU_HEALTH_INTERVAL"] = "1"

    def gpt_case(dims, health):
        hcg = _pp_topology(dims)
        gpt = pp_gpt(inp)
        step = PipelineParallelTrainStep(
            gpt, F.cross_entropy, optimizer.Adam(
                learning_rate=1e-2, parameters=gpt.parameters()),
            hcg=hcg, num_micro=2, donate=False, health=health)
        rec = _pp_run(step, inp, "", PP_STEPS)
        rec["wte_master"] = _np(step.params["edge"]["wte.weight"])
        rec["health"] = dict(step.last_health) if health else None
        step.sync_to_layer()
        rec["params"] = _pp_params(gpt)
        return rec

    if n == 2:
        out["gpt"] = gpt_case({"pp": 2}, True)
        # PipelineParallel.train_batch on a PipelineLayer
        hcg = _pp_topology({"pp": 2})
        layers = [LayerDesc(nn.Embedding, 16, 8, device="cpu")]
        layers += [LayerDesc(nn.Linear, 8, 8, device="cpu")
                   for _ in range(5)]
        pl = PipelineLayer(layers=layers, num_stages=2,
                           seg_method="layer:Linear",
                           loss_fn=lambda o, y: ((o - y) ** 2).mean())
        load_numpy_params(pl, {k[3:]: v for k, v in inp.items()
                               if k.startswith("pl.")})
        model = PipelineParallel(pl, hcg=hcg)
        opt = optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
        losses = [float(model.train_batch(
            [_t(inp["pl_X"]).long(), _t(inp["pl_Y"])], opt))
            for _ in range(5)]
        model._train_step.sync_to_layer()
        out["layer"] = dict(losses=losses,
                            counts=list(model._train_step.run.counts),
                            params=_pp_params(pl))
        # the 1F1B bound: M = 8 S
        hcg = _pp_topology({"pp": 2})
        gpt = pp_gpt(inp)
        step = PipelineParallelTrainStep(
            gpt, F.cross_entropy, optimizer.Adam(
                learning_rate=1e-2, parameters=gpt.parameters()),
            hcg=hcg, num_micro=16)
        out["bound"] = _pp_run(step, inp, "m16_", 1)
        # fp16: an inf gradient on stage 1 only
        hcg = _pp_topology({"pp": 2})
        strategy = DistributedStrategy()
        strategy.amp = True
        strategy.amp_configs = {"dtype": "float16",
                                "init_loss_scaling": 1024.0}
        rec = {}
        for armed in (False, True):
            pl = pp_poison_layer()
            pp_poison_layer.armed = armed and hcg.get_stage_id() == 1
            step = PipelineParallelTrainStep(
                pl, pl._loss_fn, optimizer.SGD(
                    learning_rate=0.1, parameters=pl.parameters()),
                hcg=hcg, strategy=strategy)
            before = {k: _np(v).copy() for k, v in step._masters.items()}
            loss = float(step(_t(inp["fp16_X"]), _t(inp["fp16_Y"])))
            after = {k: _np(v).copy() for k, v in step._masters.items()}
            rec[armed] = dict(
                loss=loss, scale=step.scaler_state["scale"],
                good=step.scaler_state["good"],
                moved=sorted(k for k in before
                             if not np.array_equal(before[k], after[k])),
                names=sorted(before))
        pp_poison_layer.armed = False
        out["fp16"] = rec
        # O2 bf16: the boundary and its gradient in bf16 over gloo
        hcg = _pp_topology({"pp": 2})
        strategy = DistributedStrategy()
        strategy.amp = True
        gpt = pp_gpt(inp)
        step = PipelineParallelTrainStep(
            gpt, F.cross_entropy, optimizer.Adam(
                learning_rate=1e-2, parameters=gpt.parameters()),
            hcg=hcg, strategy=strategy, num_micro=2)
        out["bf16"] = _pp_run(step, inp, "", 2)
    else:
        out["gpt"] = gpt_case({"pp": 2, "dp": 2}, False)
        hcg = _pp_topology({"pp": 4})
        g5 = pp_gpt(inp, "g5.", pp_g5_config())
        step = PipelineParallelTrainStep(
            g5, F.cross_entropy, optimizer.Adam(
                learning_rate=1e-2, parameters=g5.parameters()),
            hcg=hcg, num_micro=4)
        out["g5"] = _pp_run(step, inp, "g5_", PP_STEPS)
        step.sync_to_layer()
        out["g5"]["params"] = _pp_params(g5)
    topology.set_hybrid_communicate_group(None)
    torch.save(out, os.path.join(outdir, f"pipeline.{r}.pt"))
    dist.destroy_process_group()


SCENARIOS = {"collective": collective, "dp": data_parallel,
             "resnet_dp": resnet_dp, "zero": zero, "zero_ckpt": zero_ckpt,
             "pipeline": pipeline}


def run_world(scenario, nprocs, outdir, timeout=120):
    """Run one world in a process group of its own, killed whole past
    ``timeout`` seconds; returns every rank's results. Raises with the
    world's output when a rank failed or the time ran out."""
    import signal
    import subprocess
    import torch
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_TRAINER_ID", None)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(nprocs),
         str(outdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise RuntimeError(f"{scenario} world: no end within {timeout} s:"
                           f"\n{log[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
    if proc.returncode != 0:
        raise RuntimeError(f"{scenario} world: exit {proc.returncode}:\n"
                           f"{log[-4000:]}")
    return [torch.load(os.path.join(str(outdir), f"{scenario}.{r}.pt"),
                       weights_only=False) for r in range(nprocs)]


def _entry(scenario, outdir):
    import torch
    torch.set_num_threads(1)
    SCENARIOS[scenario](outdir)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    from paddle_tpu_torch.distributed import spawn
    name, nprocs, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    spawn(_entry, args=(name, outdir), nprocs=nprocs)
