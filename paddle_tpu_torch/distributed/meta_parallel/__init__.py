"""Hybrid-parallel building blocks (counterpart of
``paddle_tpu/distributed/meta_parallel``): the pipeline.

The tensor-parallel layers (``ColumnParallelLinear``,
``RowParallelLinear``, ``VocabParallelEmbedding``,
``ParallelCrossEntropy``, the RNG tracker) and the hybrid engine wait for
ROADMAP A11 item 2.
"""
from .pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc,
)
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, PipelineParallelTrainStep,
)
