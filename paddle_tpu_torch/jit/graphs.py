"""CUDA graphs of one step function, one per key, in one memory pool: the
counterpart of ``jax.jit``'s executable cache for a step that is called
over and over with the same shapes (the training step, serving's decode
step).

``StepGraphs.run(key, fn)`` on a key's first use runs ``fn`` once
uncaptured on a side stream (its real work: one training update, one
decode iteration; it also loads the kernel library, makes cuBLAS's and
cuDNN's handles and workspaces, builds cached index tensors and grows
the allocator, none of which a capture may do), then captures the same
``fn`` into a CUDA graph in the object's one pool. Capturing launches
nothing, so ``fn`` never runs twice for one call. The launch counts the
capture made are set aside (``ops.kernels.recorded``) and added once per
replay. Later uses of the key replay the graph and return the tensors
``fn`` returned while it was captured: the graph writes them anew on
every replay.

A capture or a replay that fails raises, naming the key and the CUDA
error; nothing falls back to running ``fn`` uncaptured (what a failed
capture leaves behind in the allocator and the generators is put right
first). Capture errors
are those of the capturing thread only (``capture_error_mode=
"thread_local"``): autograd's device thread launches the backward into
the capturing stream, and a serving engine captures on its loop thread
while others submit requests.

``fn`` must read and write only tensors that outlive the call at fixed
addresses (static inputs, parameters and slots updated in place) and
must not wait on the device (``.item()``, ``float(t)``). The default
CUDA generator is registered with every graph by PyTorch; an explicit
generator ``fn`` draws from (``framework.random.generators_drawn``
notes those of the first run) is registered here, so a replay draws
what an uncaptured run would.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Hashable

import torch

from ..framework import random as _random
from ..ops import kernels as _kernels
from ..profiler import compile_watch as _compile_watch


class StepGraphs:
    """Graphs of one step function on ``device``, keyed by the caller
    (a batch signature and a variant, a lane bucket and a variant).

    ``captures``: graphs captured; ``replays``: {key: replays};
    ``pool_bytes``: the growth of the allocator's reserved memory over
    the captures (the pool's activations and outputs)."""

    def __init__(self, device, owner: str = "step"):
        self.device = torch.device(device)
        self.owner = owner
        self.graphs: Dict[Hashable, tuple] = {}  # key -> (graph, counts, out)
        self.replays: Dict[Hashable, int] = {}
        self.captures = 0
        self.pool_bytes = 0
        self._pool = None
        self._side = None

    def run(self, key, fn: Callable):
        """``fn()``'s results: from the uncaptured run on the key's first
        use (which also captures it), else from a replay."""
        entry = self.graphs.get(key)
        if entry is None:
            return self._capture(key, fn)
        graph, counts, out = entry
        try:
            graph.replay()
        except Exception as e:
            raise RuntimeError(f"{self.owner}: replaying the graph of "
                               f"{key!r} failed: {e}") from e
        _kernels.add_counts(counts)
        self.replays[key] += 1
        return out

    def _reserved(self) -> int:
        return torch.cuda.memory_stats(self.device).get(
            "reserved_bytes.all.current", 0)

    def _capture(self, key, fn: Callable):
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side
        side.wait_stream(cur)
        with _random.generators_drawn() as drawn, torch.cuda.stream(side):
            result = fn()
        cur.wait_stream(side)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        for gen in drawn:
            if gen.device.type == "cuda":
                graph.register_generator_state(gen)
        reserved = self._reserved()
        err = None
        t0 = time.perf_counter()
        with _kernels.recorded() as counts, torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException as e:  # noqa: B036 - re-raised below
                err = e
            try:
                graph.capture_end()
            except Exception as e:
                err = err or e
        if err is not None:
            self._recover(drawn, side)
            raise RuntimeError(f"{self.owner}: capturing the graph of "
                               f"{key!r} failed: {err}") from err
        cur.wait_stream(side)
        # the capture is the port's compile: attributed to the entry pushed
        _compile_watch.record("graph_capture", time.perf_counter() - t0)
        self.pool_bytes += self._reserved() - reserved
        self.graphs[key] = (graph, counts, out)
        self.replays[key] = 0
        self.captures += 1
        return result

    def _recover(self, drawn, side) -> None:
        """After a failed capture, which did not end: the allocator still
        sends the pool its allocations and defers every free in the
        process (no memory would return), and the default generator (and
        each registered one) stays in capture mode, so every later draw
        would raise. End the pool's allocation, release the failed
        capture's hold on it (later captures take a new pool), and run an
        empty capture, which begins and ends the generators' capture
        state again."""
        dev = self.device.index
        if dev is None:
            dev = torch.cuda.current_device()
        try:
            torch._C._cuda_endAllocateToPool(dev, self._pool)
        except RuntimeError:  # a build whose capture_end had ended it
            pass
        torch._C._cuda_releasePool(dev, self._pool)
        self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in drawn:
            if gen.device.type == "cuda":
                graph.register_generator_state(gen)
        with warnings.catch_warnings(), torch.cuda.stream(side):
            warnings.simplefilter("ignore")  # "the CUDA Graph is empty"
            graph.capture_begin()
            graph.capture_end()

    def clear(self) -> None:
        """Drop every graph (and with the last one the pool's memory,
        which ``torch.cuda.empty_cache()`` then returns)."""
        self.graphs.clear()
        self.replays.clear()
        self._pool = None


__all__ = ["StepGraphs"]
