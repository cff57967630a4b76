"""Pipeline model description — LayerDesc / SharedLayerDesc / PipelineLayer
(counterpart of ``paddle_tpu/distributed/meta_parallel/pp_layers.py``).

PaddlePaddle's ``PipelineLayer`` (``fleet/meta_parallel/parallel_layers/
pp_layers.py:132``) cuts a flat ``LayerDesc`` list into per-rank stages.
As in the reference, the port's builds the whole model in every process;
``PipelineParallelTrainStep`` then runs on each rank only the stage its
``pp`` coordinate owns, over the homogeneous middle run of layers
(``scan_region``), with the layers before and after it (the "edge")
replicated on every stage.

Eager ``forward`` runs the layers in order, so a PipelineLayer is also a
correct single-process model.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ...nn.layers_common import LayerList


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:31)."""

    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, torch.nn.Module)):
            raise TypeError(f"LayerDesc needs a Layer subclass, got "
                            f"{layer_cls}")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self) -> torch.nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """Weight-tied layer (reference pp_layers.py:49, e.g. the input and
    output embeddings). Every desc with the same ``key`` shares ONE layer
    instance, registered once on the PipelineLayer; its gradient sums
    both uses. ``forward_func(layer, x)`` customizes a reuse (e.g. the
    logits ``x @ embedding.weight.T`` of the output head)."""

    def __init__(self, key, layer_cls, forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedCall(torch.nn.Module):
    """Calls a shared instance without registering its parameters again
    (held outside the module tree, so ``named_parameters`` sees them once,
    on the PipelineLayer's own ``shared_<key>``)."""

    def __init__(self, shared: torch.nn.Module,
                 forward_func: Optional[Callable]):
        super().__init__()
        object.__setattr__(self, "_shared_ref", shared)
        object.__setattr__(self, "_forward_func", forward_func)

    def forward(self, *args, **kw):
        if self._forward_func is not None:
            return self._forward_func(self._shared_ref, *args, **kw)
        return self._shared_ref(*args, **kw)


def _param_signature(layer: torch.nn.Module):
    """Structural signature: sorted (name, shape, dtype) of the sub-tree."""
    return tuple(sorted((k, tuple(p.shape), str(p.dtype).replace("torch.",
                                                                  ""))
                        for k, p in layer.named_parameters()))


class PipelineLayer(torch.nn.Module):
    """Flat layer list + stage segmentation (reference pp_layers.py:132).

    ``layers`` is a list of layers, LayerDescs, SharedLayerDescs or plain
    callables; ``num_stages`` or ``topology`` (its "pipe" dimension) gives
    the pp degree; ``seg_method`` is "uniform" or "layer:ClassName" (a
    cut before instances of ClassName). ``loss_fn`` is what
    ``PipelineParallel.train_batch`` trains with."""

    def __init__(self, layers: Sequence[Any], num_stages: Optional[int] = None,
                 topology=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, loss_fn=None, **kw):
        super().__init__()
        self._num_stages = num_stages or (
            topology.get_dim("pipe") if topology is not None else 1)
        self.seg_method = seg_method
        self.recompute_interval = recompute_interval
        self._loss_fn = loss_fn
        self._shared: Dict[str, torch.nn.Module] = {}
        built: List[torch.nn.Module] = []
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    shared = d.build_layer()
                    self._shared[d.layer_name] = shared
                    # the owned instance: its parameters are tracked once
                    setattr(self, f"shared_{d.layer_name}", shared)
                built.append(_SharedCall(self._shared[d.layer_name],
                                         d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, torch.nn.Module):
                built.append(d)
            elif callable(d):
                built.append(_FnLayer(d))
            else:
                raise TypeError(f"bad pipeline item {d!r}")
        self.run_function = LayerList(built)

    # -- eager path ---------------------------------------------------------
    def forward(self, x):
        for lyr in self.run_function:
            x = lyr(x)
        return x

    # -- segmentation -------------------------------------------------------
    @property
    def num_stages(self) -> int:
        return self._num_stages

    def segment(self) -> List[int]:
        """Stage boundary indices [b0..bS] over the layer list."""
        n = len(self.run_function)
        S = self._num_stages
        if self.seg_method.startswith("layer:"):
            cls_name = self.seg_method.split(":", 1)[1]
            cuts = [i for i, lyr in enumerate(self.run_function)
                    if type(lyr).__name__ == cls_name]
            # the cut layers split uniformly over the stages; leading
            # layers that are not cut join stage 0, trailing ones the last
            assert len(cuts) >= S, \
                f"{len(cuts)} x {cls_name} layers < {S} stages"
            per = len(cuts) // S
            bounds = [0]
            for s in range(1, S):
                bounds.append(cuts[s * per])
            bounds.append(n)
            return bounds
        per, rem = divmod(n, S)  # uniform, the remainder to early stages
        bounds = [0]
        for s in range(S):
            bounds.append(bounds[-1] + per + (1 if s < rem else 0))
        return bounds

    def get_stage_of(self, layer_idx: int) -> int:
        b = self.segment()
        for s in range(self._num_stages):
            if b[s] <= layer_idx < b[s + 1]:
                return s
        raise IndexError(layer_idx)

    # -- the homogeneous run the stages split -------------------------------
    def scan_region(self):
        """(start, stop): the longest run of structurally identical
        consecutive layers (one parameter signature), which the pipeline
        splits over its stages. Layers before it are the replicated
        pre-part, after it the post-part. ``stop - start`` need not
        divide by the stage count (uneven counts, reference
        pp_layers.py:63)."""
        sigs = [_param_signature(lyr) for lyr in self.run_function]
        best = (0, 0)
        i = 0
        while i < len(sigs):
            j = i + 1
            while j < len(sigs) and sigs[j] == sigs[i] and sigs[i]:
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = max(j, i + 1)
        return best


class _FnLayer(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        object.__setattr__(self, "_fn", fn)

    def forward(self, *a, **k):
        return self._fn(*a, **k)
