"""The port's pipeline over a gloo world of 4 against the JAX package
(the world of 2 and the module's rules are ``test_torch_pipeline.py``):

- GPT tiny over pp 2 x dp 2, M 2, Adam(1e-2), 3 steps: each micro-batch's
  rows split over dp, block gradients averaged over dp, edge gradients
  summed over pp and averaged over dp; the losses within rtol/atol 2e-4 of
  the reference's pipeline (pp 2 x dp 4 on its mesh: the same global
  batch), the parameters after ``sync_to_layer`` under the rule of
  ``test_torch_pipeline.py``, and the same bits on every rank of a dp
  pair, and of the edge on every rank;
- a 5-layer GPT over pp 4: ``run.counts`` [2, 1, 1, 1] as the reference
  gives, M 4, Adam(1e-2), 3 steps, held as the reference's own test of
  uneven stages holds its pipeline: against the single-device
  ``TrainStep`` (losses within rtol/atol 2e-4, parameters under the same
  rule); stage s holds at most 4 - s micro-batches.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.meta_parallel import \
    PipelineParallelTrainStep as JPipelineStep
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.nn import functional as JF

import test_torch_pipeline as tp

STEPS = tp.STEPS


@pytest.fixture(scope="module")
def inputs():
    return tp._inputs()


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return tp.world(4, inputs, tmp_path_factory)


def test_gpt_pp2_dp2_matches_reference_pipeline(world4, inputs):
    ref = tp.ref_gpt(inputs)
    for rk in world4:
        np.testing.assert_allclose(rk["gpt"]["losses"], ref["losses"],
                                   **tp.LOSS_TOL)
        tp.check_params(rk["gpt"]["params"], ref)
        assert rk["gpt"]["losses"] == world4[0]["gpt"]["losses"]
    # rank = dp * 2 + pp: ranks 0/2 hold stage 0, ranks 1/3 stage 1
    for k, v in world4[0]["gpt"]["params"].items():
        same = [1, 2, 3] if not k.startswith("blocks.") else [2]
        for r in same:
            assert np.array_equal(v, world4[r]["gpt"]["params"][k]), (k, r)
    assert [rk["gpt"]["stage"] for rk in world4] == [0, 1, 0, 1]
    # the rows of each micro-batch split over dp: half the boundary
    assert world4[0]["gpt"]["transfers"]["bytes"] == 4 * 2 * 16 * 64 * 4
    assert world4[0]["gpt"]["collectives"]["all_reduce"] == 1


def _ref_g5(inputs):
    model = JGPT(tp._ref_g5_config())
    for k, p in model.named_parameters():
        p.set_value(inputs["g5." + k])
    opt = jopt.Adam(learning_rate=tp.LR, parameters=model.parameters())
    step = JTrainStep(model, JF.cross_entropy, opt, donate=False)
    losses = [float(step(paddle.to_tensor(inputs[f"g5_ids{s}"]),
                         paddle.to_tensor(inputs[f"g5_labels{s}"])))
              for s in range(STEPS)]
    return dict(losses=losses,
                params={k: np.asarray(v) for k, v in step.params.items()},
                moment2={k: np.asarray(v["moment2"])
                         for k, v in step.opt_state.items()})


def test_five_layers_over_pp4_match_single_device(world4, inputs):
    hcg = tp._ref_hcg({"pp": 4})
    try:
        model = JGPT(tp._ref_g5_config())
        step = JPipelineStep(
            model, JF.cross_entropy, jopt.Adam(
                learning_rate=tp.LR, parameters=model.parameters()),
            hcg=hcg, num_micro=4, donate=False)
        ref_counts = step.run.counts
    finally:
        jdist.set_hybrid_communicate_group(None)
    assert ref_counts == [2, 1, 1, 1]
    ref = _ref_g5(inputs)
    for rk in world4:
        g = rk["g5"]
        assert g["counts"] == ref_counts
        assert g["peak"] == 4 - g["stage"]
        np.testing.assert_allclose(g["losses"], ref["losses"], **tp.LOSS_TOL)
        tp.check_params(g["params"], ref)
    assert [rk["g5"]["stage"] for rk in world4] == [0, 1, 2, 3]
