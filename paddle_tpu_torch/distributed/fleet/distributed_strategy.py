"""DistributedStrategy — the single config object for every feature
(counterpart of ``paddle_tpu/distributed/fleet/distributed_strategy.py``,
ported as it is).

PaddlePaddle keeps one protobuf message per feature (amp, recompute,
sharding, pipeline, tensor_parallel, hybrid_configs, ...); the reference
and the port keep dataclasses serialized to JSON, of the same shape.
``to_dict``/``from_dict``/``to_json``/``from_json`` give the reference's
dicts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class AMPConfig:
    enable: bool = False
    dtype: str = "bfloat16"          # bf16 needs no loss scaling
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = True
    custom_white_list: tuple = ()
    custom_black_list: tuple = ()


@dataclasses.dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: tuple = ()          # layer names to checkpoint at


@dataclasses.dataclass
class ShardingConfig:
    enable: bool = False
    stage: int = 1                   # ZeRO stage 1/2/3
    degree: int = 1
    offload: bool = False
    segment_broadcast_MB: float = 32.0


@dataclasses.dataclass
class PipelineConfig:
    enable: bool = False
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"


@dataclasses.dataclass
class TensorParallelConfig:
    enable: bool = False
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = -1              # -1: absorb remaining devices
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1              # sequence/context parallel (ours)
    sp_mode: str = "ring"            # "ring" | "ulysses" attention flavor


class DistributedStrategy:
    """Feature-flag container, attribute-compatible with the reference's
    strategy object (`strategy.amp = True`, `strategy.hybrid_configs = {...}`)."""

    def __init__(self):
        self._amp = AMPConfig()
        self._recompute = RecomputeConfig()
        self._sharding = ShardingConfig()
        self._pipeline = PipelineConfig()
        self._tensor_parallel = TensorParallelConfig()
        self._hybrid = HybridConfig()
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True   # parity flag
        self.nccl_comm_num = 1
        self.heter_ccl_mode = False

    # -- feature switches mirror reference property style -------------------
    @property
    def amp(self) -> bool:
        return self._amp.enable

    @amp.setter
    def amp(self, flag: bool):
        self._amp.enable = bool(flag)

    @property
    def amp_configs(self):
        return dataclasses.asdict(self._amp)

    @amp_configs.setter
    def amp_configs(self, cfg: Dict[str, Any]):
        for k, v in cfg.items():
            if hasattr(self._amp, k):
                setattr(self._amp, k, v)

    @property
    def recompute(self) -> bool:
        return self._recompute.enable

    @recompute.setter
    def recompute(self, flag: bool):
        self._recompute.enable = bool(flag)

    @property
    def recompute_configs(self):
        return dataclasses.asdict(self._recompute)

    @recompute_configs.setter
    def recompute_configs(self, cfg):
        for k, v in cfg.items():
            if hasattr(self._recompute, k):
                setattr(self._recompute, k, v)

    @property
    def sharding(self) -> bool:
        return self._sharding.enable

    @sharding.setter
    def sharding(self, flag: bool):
        self._sharding.enable = bool(flag)

    @property
    def sharding_configs(self):
        return dataclasses.asdict(self._sharding)

    @sharding_configs.setter
    def sharding_configs(self, cfg):
        for k, v in cfg.items():
            if hasattr(self._sharding, k):
                setattr(self._sharding, k, v)

    @property
    def pipeline(self) -> bool:
        return self._pipeline.enable

    @pipeline.setter
    def pipeline(self, flag: bool):
        self._pipeline.enable = bool(flag)

    @property
    def pipeline_configs(self):
        return dataclasses.asdict(self._pipeline)

    @pipeline_configs.setter
    def pipeline_configs(self, cfg):
        for k, v in cfg.items():
            if hasattr(self._pipeline, k):
                setattr(self._pipeline, k, v)

    @property
    def tensor_parallel(self) -> bool:
        return self._tensor_parallel.enable

    @tensor_parallel.setter
    def tensor_parallel(self, flag: bool):
        self._tensor_parallel.enable = bool(flag)

    @property
    def tensor_parallel_configs(self):
        return dataclasses.asdict(self._tensor_parallel)

    @tensor_parallel_configs.setter
    def tensor_parallel_configs(self, cfg):
        for k, v in cfg.items():
            if hasattr(self._tensor_parallel, k):
                setattr(self._tensor_parallel, k, v)

    @property
    def hybrid_configs(self):
        return dataclasses.asdict(self._hybrid)

    @hybrid_configs.setter
    def hybrid_configs(self, cfg: Dict[str, Any]):
        for k, v in cfg.items():
            if hasattr(self._hybrid, k):
                setattr(self._hybrid, k, v)

    # -- mesh dims derived from hybrid config --------------------------------
    def mesh_dims(self) -> Dict[str, int]:
        h = self._hybrid
        dims = {"pp": h.pp_degree, "sharding": max(
            h.sharding_degree, self._sharding.degree
            if self._sharding.enable else 1),
            "sp": h.sep_degree, "mp": h.mp_degree}
        if h.dp_degree > 0:
            dims["dp"] = h.dp_degree
        return dims

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "amp": self.amp_configs,
            "recompute": self.recompute_configs,
            "sharding": self.sharding_configs,
            "pipeline": self.pipeline_configs,
            "tensor_parallel": self.tensor_parallel_configs,
            "hybrid_configs": self.hybrid_configs,
            "gradient_merge": self.gradient_merge,
            "gradient_merge_configs": self.gradient_merge_configs,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DistributedStrategy":
        s = cls()
        for key in ("amp", "recompute", "sharding", "pipeline",
                    "tensor_parallel"):
            if key in d:
                setattr(s, key + "_configs", d[key])
                setattr(s, key, d[key].get("enable", False))
        if "hybrid_configs" in d:
            s.hybrid_configs = d["hybrid_configs"]
        s.gradient_merge = d.get("gradient_merge", False)
        s.gradient_merge_configs = d.get("gradient_merge_configs",
                                         {"k_steps": 1})
        return s

    @classmethod
    def from_json(cls, text: str) -> "DistributedStrategy":
        return cls.from_dict(json.loads(text))

    def __repr__(self):
        return f"DistributedStrategy({self.to_dict()!r})"
