"""Hybrid-parallel topology — the rank grid and its named axes
(counterpart of ``paddle_tpu/distributed/topology.py``).

The reference builds one ``jax.sharding.Mesh`` whose named axes are the
parallelism axes, and a group is a view of one axis. The port has one
process per rank, so its mesh is a grid of RANKS with the reference's
axis names and order (``build_mesh``), and each axis slice gets a torch
process group (``HybridCommunicateGroup``). Rank r sits where the
reference's device r sits.

Axis canon (outermost first):

    dp        data parallel            (batch axis)
    pp        pipeline parallel        (stage axis)
    sharding  ZeRO parameter/optimizer sharding
    sp        sequence/context parallel
    mp        tensor/model parallel    (innermost)

Only data parallelism runs on these groups so far; an axis other than
``dp`` may be larger than 1 and its groups exist, and the engines that
would use them (``meta_parallel``, ``sharding``, sequence parallelism)
are later slices of ROADMAP A11.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AXIS_CANON = ("dp", "pp", "sharding", "sp", "mp")

# reference axis-name spellings -> ours
_AXIS_ALIASES = {"data": "dp", "pipe": "pp", "model": "mp", "sep": "sp",
                 "sequence": "sp", "tensor": "mp", "expert": "ep"}


def canon_axis(name: str) -> str:
    return _AXIS_ALIASES.get(name, name)


class CommunicateTopology:
    """Cartesian rank topology (paddle's ``fleet/base/topology.py:36``)."""

    def __init__(self,
                 hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                      "sharding", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1)):
        assert len(hybrid_group_names) == len(dims)
        self._parallel_names = [canon_axis(n) for n in hybrid_group_names]
        self._dims = list(int(d) for d in dims)
        self._world_size = int(np.prod(self._dims))
        ranks = np.arange(self._world_size).reshape(self._dims)
        self._rank_grid = ranks
        self._coord_of = {}
        for coord in np.ndindex(*self._dims):
            self._coord_of[int(ranks[coord])] = tuple(int(c) for c in coord)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(canon_axis(axis_name))]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **coords) -> int:
        idx = [coords[n] for n in self._parallel_names]
        return int(self._rank_grid[tuple(idx)])

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._coord_of[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on `axis_name` equals `index`."""
        ax = self._parallel_names.index(canon_axis(axis_name))
        return sorted(int(r) for r, c in self._coord_of.items()
                      if c[ax] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Rank groups that communicate along `axis_name`: one list per
        combination of the other axes."""
        ax = self._parallel_names.index(canon_axis(axis_name))
        groups = collections.defaultdict(list)
        for r in range(self._world_size):
            c = self._coord_of[r]
            key = c[:ax] + c[ax + 1:]
            groups[key].append(r)
        return [sorted(v) for _, v in sorted(groups.items())]

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = dict(zip(self._parallel_names, self.get_coord(global_rank)))
        coord.update({canon_axis(k): v for k, v in kwargs.items()})
        return self.get_rank(**coord)


class RankGrid:
    """The port's mesh: global ranks laid out on named axes. ``devices``
    holds the ranks (the slot of the reference ``Mesh.devices``),
    ``axis_names`` and ``shape`` ({axis: size}) are the mesh's."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        assert self.devices.ndim == len(self.axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def coord(self, rank: int) -> Tuple[int, ...]:
        idx = np.argwhere(self.devices == rank)
        if not len(idx):
            raise ValueError(f"rank {rank} is not in the grid {self}")
        return tuple(int(i) for i in idx[0])

    def comm_lists(self, axes: Sequence[str]) -> List[List[int]]:
        """The rank lists along ``axes`` (one per combination of the other
        axes), each in row-major order over ``axes``."""
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        moved = np.transpose(self.devices, rest + pos)
        n = int(np.prod([self.devices.shape[i] for i in pos]))
        return [[int(r) for r in row] for row in moved.reshape(-1, n)]

    def axis_ranks(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks along ``axes`` of the slice that holds ``rank``."""
        for ranks in self.comm_lists(axes):
            if rank in ranks:
                return ranks
        raise ValueError(f"rank {rank} is not in the grid {self}")

    def __repr__(self):
        return f"RankGrid({dict(self.shape)})"


def build_mesh(dims: Dict[str, int],
               devices: Optional[Sequence] = None) -> RankGrid:
    """The rank grid for {axis: size}: axes ordered per AXIS_CANON
    (outermost dp ... innermost mp), extra axes appended in the given
    order; ``dp`` absorbs the remaining ranks (created if absent).
    ``devices`` are the ranks to lay out (default: the world's)."""
    dims = {canon_axis(k): v for k, v in dims.items() if v is not None}
    names = [a for a in AXIS_CANON if dims.get(a, 1) > 1 or a in dims]
    names += [a for a in dims if a not in names]
    if not names:
        names = ["dp"]
    sizes = [max(1, int(dims.get(a, 1))) for a in names]
    if devices is None:
        from .collective import _world_size
        devices = list(range(_world_size()))
    devices = list(devices)
    need = int(np.prod(sizes))
    if need < len(devices) and len(devices) % need == 0:
        if "dp" in names:
            sizes[names.index("dp")] *= len(devices) // need
        else:
            names.insert(0, "dp")
            sizes.insert(0, len(devices) // need)
        need = len(devices)
    if need > len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {need} "
                         f"ranks, have {len(devices)}")
    return RankGrid(np.array(devices[:need]).reshape(sizes), names)


class HybridCommunicateGroup:
    """Per-axis groups over one rank grid (paddle's ``topology.py:117``).

    With ``torch.distributed`` initialized, every axis slice gets its
    process group at construction (every rank creates every group, in
    one order, as torch requires), and this rank's group of each axis is
    kept. Before ``init_parallel_env`` the groups are descriptors whose
    collectives raise."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 mesh: Optional[RankGrid] = None,
                 dims: Optional[Dict[str, int]] = None):
        if mesh is None:
            if topology is not None:
                dims = dict(zip(topology.get_hybrid_group_names(),
                                topology._dims))
            assert dims is not None, "need topology, mesh or dims"
            mesh = build_mesh(dims)
        self._mesh = mesh
        self.sp_mode = "ring"
        ax = dict(mesh.shape)
        self._dp_degree = ax.get("dp", 1)
        self._pp_degree = ax.get("pp", 1)
        self._sharding_degree = ax.get("sharding", 1)
        self._sp_degree = ax.get("sp", 1)
        self._mp_degree = ax.get("mp", 1)
        self._ep_degree = ax.get("ep", 1)
        self._topo = topology or CommunicateTopology(
            list(mesh.axis_names), list(mesh.devices.shape))
        from .collective import _make_groups, _proc_rank
        self._rank = _proc_rank()
        self._groups = {}
        for name in mesh.axis_names:
            self._groups[name] = _make_groups(
                mesh.comm_lists((name,)), (name,), mesh)
        self._check = _make_groups(mesh.comm_lists(mesh.axis_names),
                                   tuple(mesh.axis_names), mesh,
                                   name="check")

    # -- mesh ----------------------------------------------------------------
    @property
    def mesh(self) -> RankGrid:
        return self._mesh

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def axis_size(self, name: str) -> int:
        return dict(self._mesh.shape).get(canon_axis(name), 1)

    def _axis_group(self, name: str):
        name = canon_axis(name)
        if name not in self._groups:
            # an axis of size 1 that the grid does not name: this rank alone
            from .collective import Group
            self._groups[name] = Group(self._mesh, (name,),
                                       ranks=[self._rank], pg=None)
        return self._groups[name]

    def _coord(self, name: str) -> int:
        name = canon_axis(name)
        if name not in self._mesh.axis_names:
            return 0
        return self._mesh.coord(self._rank)[
            self._mesh.axis_names.index(name)]

    # -- reference API parity ------------------------------------------------
    def get_parallel_mode(self) -> str:
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding_parallel"
        if self._mp_degree > 1:
            return "model_parallel"
        return "data_parallel"

    def get_global_rank(self) -> int:
        return self._rank

    # data parallel
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_rank(self) -> int:
        return self._coord("dp")

    def get_data_parallel_group(self):
        return self._axis_group("dp")

    # model (tensor) parallel
    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_rank(self) -> int:
        return self._coord("mp")

    def get_model_parallel_group(self):
        return self._axis_group("mp")

    # pipeline
    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_stage_id(self) -> int:
        return self._coord("pp")

    def get_pipe_parallel_group(self):
        return self._axis_group("pp")

    # sharding
    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_rank(self) -> int:
        return self._coord("sharding")

    def get_sharding_parallel_group(self):
        return self._axis_group("sharding")

    # sequence/context
    def get_sep_parallel_world_size(self) -> int:
        return self._sp_degree

    def get_sep_parallel_group(self):
        return self._axis_group("sp")

    # expert parallel (MoE)
    def get_expert_parallel_world_size(self) -> int:
        return self._ep_degree

    def get_expert_parallel_group(self):
        return self._axis_group("ep")

    def get_check_parallel_group(self):
        return self._check

    def topology_description(self) -> str:
        return (f"HybridCommunicateGroup(dp={self._dp_degree}, "
                f"pp={self._pp_degree}, sharding={self._sharding_degree}, "
                f"sp={self._sp_degree}, mp={self._mp_degree})")

    __repr__ = topology_description


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG
