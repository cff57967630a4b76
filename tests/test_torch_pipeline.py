"""The port's pipeline parallelism against the JAX package's.

The reference compiles the pipeline into one SPMD program on its
8-device CPU mesh (``PipelineParallelTrainStep``; a pp axis of 2 leaves
dp 4); the port runs a 1F1B schedule over a gloo world on the CPU, one
process a rank (``tests/torch_dist_workers.py pipeline``, started once
for this module with a time limit of its own; the world of 4 is
``test_torch_pipeline_world4.py``). Weights come from the reference's
models (``load_numpy_params``), dropout is 0, and each case is held
against the reference's own pipeline, or against its single-device
``TrainStep`` where that is the reference test's own oracle
(``tests/test_pipeline_parallel.py``):

- ``DistributedStrategy``'s dicts and JSON, and ``PipelineLayer``'s
  segmentation, scan region and tied layer, equal to the reference's;
  ``GPT.pipeline_pre``/``pipeline_post`` within 1e-5;
- GPT tiny over pp 2, M 2, Adam(1e-2), 3 steps: the losses within
  rtol/atol 2e-4 of the reference's pipeline; after ``sync_to_layer``
  every rank's parameters within 1e-4 of the reference's wherever the
  reference's second moment shows a live gradient (its sqrt above 1e-6;
  ``test_torch_train.py``'s rule for Adam on this model: an element
  whose second moment is small turns a reduction-order difference in
  its gradient into a larger one in its update, 3.3e-5 at worst here),
  and every element within 2 * lr * steps more (an Adam step moves an
  element whose gradient is rounding noise, the attention's key bias, by
  about lr in the noise's direction); the edge parameters bit-identical
  across ranks; the sentinel's loss and gradient norm within rtol 1e-4
  of the reference's sentinel on every rank;
- ``PipelineParallel.train_batch`` on a PipelineLayer (Embedding + 5
  Linear, ``"layer:Linear"``: counts [2, 3]), SGD, 5 steps: losses
  within rtol 1e-5 and parameters within 1e-5 of the reference's
  ``train_batch``;
- O2 bf16 (``strategy.amp``): the losses within atol 2e-2 of the
  reference's pipeline under the same strategy (bf16 rounding of a loss
  near 7, as ``test_torch_train.py`` holds O2);
- the 1F1B bound (stage s holds at most S - s micro-batches at M = 8 S),
  the kernels' launches per stage against the formula, fp16 loss scaling
  with an inf on one stage, and the raises.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    PipelineParallel as JPipelineParallel,
    PipelineParallelTrainStep as JPipelineStep,
    SharedLayerDesc as JSharedLayerDesc)
from paddle_tpu.distributed.topology import \
    HybridCommunicateGroup as JHCG
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallelTrainStep, SharedLayerDesc)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.utils.convert import load_numpy_params

import torch_dist_workers as workers

LR, STEPS = 1e-2, workers.PP_STEPS
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_ATOL = 1e-4


def _gpt_batches(prefix, n, B, L, vocab, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(n):
        out[f"{prefix}ids{s}"] = rng.integers(0, vocab, (B, L)).astype(
            np.int64)
        out[f"{prefix}labels{s}"] = rng.integers(0, vocab, (B, L)).astype(
            np.int64)
    return out


def _ref_g5_config():
    return JConfig(vocab_size=64, hidden_size=16, num_layers=5, num_heads=2,
                   max_position_embeddings=32, dropout=0.0, attn_dropout=0.0)


def _ref_layer():
    layers = [JLayerDesc(jnn.Embedding, 16, 8)]
    layers += [JLayerDesc(jnn.Linear, 8, 8) for _ in range(5)]
    return JPipelineLayer(layers=layers, num_stages=2,
                          seg_method="layer:Linear",
                          loss_fn=lambda out, y: JF.mse_loss(out, y))


def _inputs():
    inp = {}
    paddle.seed(0)
    for k, p in JGPT(JConfig.tiny()).named_parameters():
        inp["gpt." + k] = np.asarray(p.data)
    paddle.seed(0)
    for k, p in JGPT(_ref_g5_config()).named_parameters():
        inp["g5." + k] = np.asarray(p.data)
    paddle.seed(0)
    for k, p in _ref_layer().named_parameters():
        inp["pl." + k] = np.asarray(p.data)
    inp.update(_gpt_batches("", STEPS, 8, 16, 1024, 0))
    inp.update(_gpt_batches("m16_", 1, 32, 16, 1024, 1))
    inp.update(_gpt_batches("g5_", STEPS, 8, 16, 64, 2))
    rs = np.random.RandomState(0)
    inp["pl_X"] = rs.randint(0, 16, (8,)).astype(np.int64)
    inp["pl_Y"] = rs.randn(8, 8).astype(np.float32)
    inp["fp16_X"] = rs.randn(8, 16).astype(np.float32)
    inp["fp16_Y"] = rs.randn(8, 16).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def world(n, inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"pipeline{n}")
    np.savez(d / "inputs.npz", **inputs)
    return workers.run_world("pipeline", n, d, timeout=240)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return world(2, inputs, tmp_path_factory)


def _ref_hcg(dims):
    hcg = JHCG(dims=dims)
    jdist.set_hybrid_communicate_group(hcg)
    return hcg


def _unstack(step, tree):
    """{model name: array} from the reference's {"edge", "blocks"} tree
    (stacked blocks [S, Lp, ...] back to per-layer names)."""
    out = {k: np.asarray(v) for k, v in tree["edge"].items()}
    run = step.run
    for k, arr in tree["blocks"].items():
        arr = np.asarray(arr)
        for s in range(run.num_stages):
            for j in range(run.counts[s]):
                out[f"{run.prefixes[run.offsets[s] + j]}.{k}"] = arr[s, j]
    return out


_REF = {}


def ref_gpt(inputs):
    """The reference's pipeline: GPT tiny over pp 2 (dp 4), M 2,
    Adam(1e-2), 3 steps with the sentinel on: losses, the last sentinel
    record, the parameters after ``sync_to_layer`` and the second
    moments, by the model's names."""
    if "gpt" not in _REF:
        import os
        interval = os.environ.get("PADDLE_TPU_HEALTH_INTERVAL")
        os.environ["PADDLE_TPU_HEALTH_INTERVAL"] = "1"
        hcg = _ref_hcg({"pp": 2})
        try:
            model = JGPT(JConfig.tiny())
            for k, p in model.named_parameters():
                p.set_value(inputs["gpt." + k])
            step = JPipelineStep(
                model, JF.cross_entropy, jopt.Adam(
                    learning_rate=LR, parameters=model.parameters()),
                hcg=hcg, num_micro=2, donate=False, health=True)
            losses = [float(step(paddle.to_tensor(inputs[f"ids{s}"]),
                                 paddle.to_tensor(inputs[f"labels{s}"])))
                      for s in range(STEPS)]
            health = dict(step.last_health)
            m2 = _unstack(step, step._unflat(
                {k: v["moment2"] for k, v in step.opt_state.items()}))
            step.sync_to_layer()
            params = {k: np.asarray(p.data)
                      for k, p in model.named_parameters()}
        finally:
            jdist.set_hybrid_communicate_group(None)
            if interval is None:
                del os.environ["PADDLE_TPU_HEALTH_INTERVAL"]
            else:
                os.environ["PADDLE_TPU_HEALTH_INTERVAL"] = interval
        _REF["gpt"] = dict(losses=losses, health=health, params=params,
                           moment2=m2)
    return _REF["gpt"]


def check_params(got, ref):
    """Every parameter against the reference's (see the module
    docstring)."""
    flip = 2 * LR * STEPS
    for k, want in ref["params"].items():
        live = np.sqrt(ref["moment2"][k]) > 1e-6
        np.testing.assert_allclose(got[k][live], want[live], atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], want, atol=flip + PARAM_ATOL,
                                   rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# in-process: the strategy, PipelineLayer, GPT's protocol, the raises
# ---------------------------------------------------------------------------
def _strategies():
    def amp(s):
        s.amp = True
        s.amp_configs = {"dtype": "float16", "init_loss_scaling": 1024.0}

    def pipeline(s):
        s.pipeline = True
        s.pipeline_configs = {"accumulate_steps": 8, "micro_batch_size": 2}

    def hybrid(s):
        s.hybrid_configs = {"dp_degree": 2, "pp_degree": 2, "mp_degree": 1}
        s.sharding = True
        s.sharding_configs = {"stage": 2, "degree": 2}

    def merge(s):
        s.recompute = True
        s.recompute_configs = {"checkpoints": ("blocks.0",)}
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 4}
        s.tensor_parallel = True
        s.tensor_parallel_configs = {"tensor_parallel_degree": 2}
    return {"default": lambda s: None, "amp": amp, "pipeline": pipeline,
            "hybrid": hybrid, "merge": merge}


@pytest.mark.parametrize("case", sorted(_strategies()))
def test_strategy_round_trips_give_the_reference_dicts(case):
    ours, ref = DistributedStrategy(), JStrategy()
    _strategies()[case](ours)
    _strategies()[case](ref)
    assert ours.to_dict() == ref.to_dict()
    assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert ours.mesh_dims() == ref.mesh_dims()
    back = DistributedStrategy.from_dict(ref.to_dict())
    assert back.to_dict() == ref.to_dict()
    back = DistributedStrategy.from_json(ref.to_json())
    assert json.loads(back.to_json()) == json.loads(ref.to_json())
    assert (back.amp, back.pipeline, back.sharding, back.recompute) == (
        ref.amp, ref.pipeline, ref.sharding, ref.recompute)


def test_fleet_facade_raises_naming_its_item():
    for fn in (lambda: fleet.init(is_collective=True),
               lambda: fleet.distributed_model(None)):
        with pytest.raises(NotImplementedError, match="A11 item 2"):
            fn()


def _cpu(cls, *a):
    return LayerDesc(cls, *a, device="cpu")


def test_pipeline_layer_segmentation_matches_reference():
    for n, S in ((9, 4), (8, 2), (5, 3), (13, 4)):
        pl = PipelineLayer([_cpu(nn.Linear, 8, 8) for _ in range(n)],
                           num_stages=S)
        ref = JPipelineLayer([JLayerDesc(jnn.Linear, 8, 8)
                              for _ in range(n)], num_stages=S)
        assert pl.segment() == ref.segment()
        assert [pl.get_stage_of(i) for i in range(n)] == \
            [ref.get_stage_of(i) for i in range(n)]
    pl = PipelineLayer([_cpu(nn.Linear, 8, 8) for _ in range(9)],
                       num_stages=4)
    assert pl.segment() == [0, 3, 5, 7, 9]
    assert pl.get_stage_of(0) == 0 and pl.get_stage_of(8) == 3


def test_seg_method_layer_and_scan_region_match_reference():
    def both(extra, S, seg):
        ours = [_cpu(nn.Embedding, 16, 8)] + [_cpu(nn.Linear, 8, 8)
                                              for _ in range(4)]
        ref = [JLayerDesc(jnn.Embedding, 16, 8)] + [
            JLayerDesc(jnn.Linear, 8, 8) for _ in range(4)]
        if extra:
            ours.append(_cpu(nn.Linear, 8, 2))
            ref.append(JLayerDesc(jnn.Linear, 8, 2))
        return (PipelineLayer(ours, num_stages=S, seg_method=seg),
                JPipelineLayer(ref, num_stages=S, seg_method=seg))

    for extra in (False, True):
        for S, seg in ((2, "layer:Linear"), (2, "uniform"),
                       (4, "layer:Linear"), (3, "uniform")):
            pl, ref = both(extra, S, seg)
            assert pl.segment() == ref.segment(), (extra, S, seg)
            assert pl.scan_region() == ref.scan_region(), (extra, S, seg)
    pl, _ = both(True, 2, "uniform")
    assert pl.scan_region() == (1, 5)


def test_shared_layer_desc_ties_weights_as_reference():
    def head(layer, x):
        return torch.matmul(x, layer.weight.t())

    def jhead(layer, x):
        from paddle_tpu.ops import matmul
        return matmul(x, layer.weight, transpose_y=True)

    pl = PipelineLayer([
        SharedLayerDesc("embed", nn.Embedding, None, "weight", 32, 8,
                        device="cpu"),
        _cpu(nn.Linear, 8, 8),
        SharedLayerDesc("embed", nn.Embedding, head, "weight", 32, 8,
                        device="cpu")], num_stages=1)
    ref = JPipelineLayer([
        JSharedLayerDesc("embed", jnn.Embedding, None, "weight", 32, 8),
        JLayerDesc(jnn.Linear, 8, 8),
        JSharedLayerDesc("embed", jnn.Embedding, jhead, "weight", 32, 8)],
        num_stages=1)
    names = [k for k, _ in pl.named_parameters()]
    assert sorted(names) == sorted(k for k, _ in ref.named_parameters())
    assert sum("embed" in n for n in names) == 1  # tied: one registration
    load_numpy_params(pl, {k: np.asarray(p.data)
                           for k, p in ref.named_parameters()})
    ids = np.array([[1, 2, 3]], dtype=np.int64)
    got = pl(torch.from_numpy(ids))
    want = np.asarray(ref(paddle.to_tensor(ids.astype(np.int32))).data)
    assert tuple(got.shape) == (1, 3, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_gpt_pipeline_pre_post_match_reference(inputs):
    model = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(model, {k[4:]: v for k, v in inputs.items()
                              if k.startswith("gpt.")})
    ref = JGPT(JConfig.tiny())
    for k, p in ref.named_parameters():
        p.set_value(inputs["gpt." + k])
    ids = inputs["ids0"][:2]
    h = model.pipeline_pre(torch.from_numpy(ids))
    jh = ref.pipeline_pre(paddle.to_tensor(ids.astype(np.int32)))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh.data),
                               atol=1e-5)
    out = model.pipeline_post(h)
    jout = ref.pipeline_post(jh)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout.data),
                               atol=1e-5)
    x = h
    for blk in model.blocks:
        x = blk(x)
    np.testing.assert_allclose(
        model.pipeline_post(x).detach().numpy(),
        model(torch.from_numpy(ids)).detach().numpy(), atol=0, rtol=0)


def _grid_hcg(shape, names):
    """A topology over ranks that no process group backs (the step's
    constructor runs no collective)."""
    from paddle_tpu_torch.distributed.topology import (HybridCommunicateGroup,
                                                       RankGrid)
    n = int(np.prod(shape))
    return HybridCommunicateGroup(
        mesh=RankGrid(np.arange(n).reshape(shape), names))


class _BNBlocks(torch.nn.Module):
    def __init__(self, edge_bn):
        super().__init__()
        self.blocks = nn.LayerList([
            nn.Sequential(nn.Linear(8, 8, device="cpu"),
                          nn.BatchNorm2D(8, device="cpu")) if not edge_bn
            else nn.Linear(8, 8, device="cpu") for _ in range(2)])
        self.pre = (nn.BatchNorm2D(8, device="cpu") if edge_bn
                    else nn.Linear(8, 8, device="cpu"))

    def pipeline_pre(self, x):
        return self.pre(x)

    def pipeline_post(self, h):
        return h


@pytest.mark.parametrize("edge_bn", [False, True], ids=["block", "edge"])
def test_batchnorm_raises_naming_it(edge_bn):
    model = _BNBlocks(edge_bn)
    with pytest.raises(ValueError, match="BatchNorm"):
        PipelineParallelTrainStep(
            model, lambda o, y: o.mean(),
            optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters()),
            hcg=_grid_hcg((2,), ("pp",)))


@pytest.mark.parametrize("axis,item", [("mp", "A11 item 2"),
                                       ("sp", "A11 item 3"),
                                       ("sharding", "A11 item 6")])
def test_other_axes_raise_naming_their_item(axis, item):
    model = GPT(GPTConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        PipelineParallelTrainStep(
            model, F.cross_entropy,
            optimizer.Adam(learning_rate=1e-3,
                           parameters=model.parameters()),
            hcg=_grid_hcg((2, 2), ("pp", axis)))


def test_health_off_by_default_and_stage_assignment(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_HEALTH", raising=False)
    model = GPT(GPTConfig.tiny(), device="cpu")
    step = PipelineParallelTrainStep(
        model, F.cross_entropy,
        optimizer.Adam(learning_rate=1e-2, parameters=model.parameters()),
        hcg=_grid_hcg((2,), ("pp",)), num_micro=2, donate=False)
    assert step._health_probe is None
    assert step.run.counts == [1, 1] and step.stage == 0
    assert sorted(step.params["blocks"]) == sorted(
        k for k, _ in model.named_parameters() if k.startswith("blocks.0."))
    assert sorted(step.params["edge"]) == [
        "ln_f.bias", "ln_f.weight", "wpe.weight", "wte.weight"]
    # the stage's masters and slots only: blocks.1 lives on stage 1
    assert not any(k.startswith("blocks.1.") for k in step.opt_state)
    strategy = DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 1}
    step = PipelineParallelTrainStep(
        model, F.cross_entropy,
        optimizer.Adam(learning_rate=1e-2, parameters=model.parameters()),
        hcg=_grid_hcg((2,), ("pp",)), strategy=strategy)
    assert step.num_micro == 2  # at least the stage count
    strategy.pipeline_configs = {"accumulate_steps": 6}
    step = PipelineParallelTrainStep(
        model, F.cross_entropy,
        optimizer.Adam(learning_rate=1e-2, parameters=model.parameters()),
        hcg=_grid_hcg((2,), ("pp",)), strategy=strategy)
    assert step.num_micro == 6


# ---------------------------------------------------------------------------
# the world of 2: pp 2
# ---------------------------------------------------------------------------
def test_gpt_pp2_losses_match_reference_pipeline(world2, inputs):
    ref = ref_gpt(inputs)
    for rk in world2:
        np.testing.assert_allclose(rk["gpt"]["losses"], ref["losses"],
                                   **LOSS_TOL)
    assert world2[0]["gpt"]["losses"] == world2[1]["gpt"]["losses"]


def test_gpt_pp2_params_after_sync_to_layer_match_reference(world2, inputs):
    ref = ref_gpt(inputs)
    for rk in world2:
        check_params(rk["gpt"]["params"], ref)
    for k, v in world2[0]["gpt"]["params"].items():
        if not k.startswith("blocks."):  # the edge: the same bits
            assert np.array_equal(v, world2[1]["gpt"]["params"][k]), k
    assert np.array_equal(world2[0]["gpt"]["wte_master"],
                          world2[1]["gpt"]["wte_master"])


def test_gpt_pp2_sentinel_matches_reference(world2, inputs):
    ref = ref_gpt(inputs)["health"]
    for rk in world2:
        h = rk["gpt"]["health"]
        assert not h["nonfinite"]
        np.testing.assert_allclose(h["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)
        assert h["loss"] == pytest.approx(rk["gpt"]["losses"][-1], rel=1e-6)


def pp_launches(blocks, last, M):
    """Kernel launches of one step on a GPT stage of ``blocks`` blocks
    under the pipeline's recompute (``chip_smoke.py``'s
    ``pp_per_step``): each block's layer norms and attention run in the
    forward and again in the replay; the last stage's final norm and
    cross-entropy too, in the loss's region."""
    per = {"layer_norm": 4 * blocks + 2 * last,
           "layer_norm_bwd": 2 * blocks + last,
           "flash_attention": 2 * blocks, "flash_attention_bwd": blocks,
           "softmax_ce_fwd": 2 * last, "softmax_ce_bwd": last}
    return {k: v * M for k, v in per.items() if v}


def test_gpt_pp2_launches_per_stage_and_transfers(world2):
    for rk in world2:
        g = rk["gpt"]
        last = int(g["stage"] == 1)
        want = pp_launches(1, last, 2)
        for launches in g["launches"]:
            assert {k: v["plain"] for k, v in launches.items()} == want
            assert all(v["kernel"] == 0 for v in launches.values())
        # M activations forward and M gradients back on the one link
        assert g["transfers"]["count"] == 4
        assert g["transfers"]["bytes"] == 4 * 4 * 16 * 64 * 4
        coll = g["collectives"]
        assert coll["pp_send"] == 2 and coll["pp_recv"] == 2
        assert coll["pp_edge_grads"] == 1 and coll["pp_loss"] == 1


def test_train_batch_on_pipeline_layer_matches_reference(world2, inputs):
    hcg = _ref_hcg({"pp": 2})
    try:
        pl = _ref_layer()
        for k, p in pl.named_parameters():
            p.set_value(inputs["pl." + k])
        model = JPipelineParallel(pl, hcg=hcg)
        opt = jopt.SGD(learning_rate=0.05, parameters=pl.parameters())
        X = paddle.to_tensor(inputs["pl_X"].astype(np.int32))
        Y = paddle.to_tensor(inputs["pl_Y"])
        losses = [float(model.train_batch([X, Y], opt)) for _ in range(5)]
        assert model._train_step.run.counts == [2, 3]
        model._train_step.sync_to_layer()
        params = {k: np.asarray(p.data) for k, p in pl.named_parameters()}
    finally:
        jdist.set_hybrid_communicate_group(None)
    for rk in world2:
        assert rk["layer"]["counts"] == [2, 3]
        np.testing.assert_allclose(rk["layer"]["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        assert rk["layer"]["losses"][-1] < rk["layer"]["losses"][0]
        for k, v in params.items():
            np.testing.assert_allclose(rk["layer"]["params"][k], v,
                                       atol=1e-5, err_msg=k)


def test_1f1b_bound_at_m_8s(world2):
    for rk in world2:
        b = rk["bound"]
        S, s = 2, b["stage"]
        assert b["peak"] == S - s
        assert np.isfinite(b["losses"][0])
        # the boundary's header (a first step), then 16 activations
        # forward and 16 gradients back on the one link
        assert b["transfers"]["count"] == 33
    assert world2[0]["bound"]["losses"] == world2[1]["bound"]["losses"]


def test_fp16_inf_on_one_stage_skips_every_update(world2):
    for rk in world2:
        clean, hit = rk["fp16"][False], rk["fp16"][True]
        # a clean step updates every master and keeps the scale
        assert clean["moved"] == [k for k in clean["names"]
                                  if not k.endswith(".scale")]
        assert clean["scale"] == 1024.0 and clean["good"] == 1
        # stage 1's inf: no master moves on either stage, the scale halves
        assert hit["moved"] == []
        assert hit["scale"] == 512.0 and hit["good"] == 0
        assert np.isfinite(hit["loss"])
    assert world2[0]["fp16"][True]["loss"] == world2[1]["fp16"][True]["loss"]


def test_o2_bf16_losses_match_reference_pipeline(world2, inputs):
    strategy = JStrategy()
    strategy.amp = True
    hcg = _ref_hcg({"pp": 2})
    try:
        model = JGPT(JConfig.tiny())
        for k, p in model.named_parameters():
            p.set_value(inputs["gpt." + k])
        step = JPipelineStep(
            model, JF.cross_entropy, jopt.Adam(
                learning_rate=LR, parameters=model.parameters()),
            hcg=hcg, strategy=strategy, num_micro=2, donate=False)
        losses = [float(step(paddle.to_tensor(inputs[f"ids{s}"]),
                             paddle.to_tensor(inputs[f"labels{s}"])))
                  for s in range(2)]
    finally:
        jdist.set_hybrid_communicate_group(None)
    for rk in world2:
        np.testing.assert_allclose(rk["bf16"]["losses"], losses, atol=2e-2,
                                   rtol=0)
        assert rk["bf16"]["collectives"]["pp_send"] == 2
        # the boundary and its gradient travel in bf16
        assert rk["bf16"]["transfers"]["bytes"] == 4 * 4 * 16 * 64 * 2
