"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``).

The reference's hook protocol (``on_{train,eval,predict}_{begin,end}``,
``on_epoch_{begin,end}``, ``on_{train,eval,predict}_batch_{begin,end}``)
and its callbacks: ProgBarLogger, FaultTolerantCheckpoint,
ModelCheckpoint, LRScheduler, EarlyStopping, and the observability plane's
ThroughputMonitor (the step-window throughput/MFU/retrace JSONL reporter,
``profiler/monitor.py``) and HealthMonitor (``profiler/health.py``),
re-exported.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..profiler.health import HealthMonitor  # noqa: F401
from ..profiler.monitor import ThroughputMonitor  # noqa: F401


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*a, **kw):
                for c in self.callbacks:
                    getattr(c, name)(*a, **kw)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-epoch progress/metric logging."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def _log(self, step, logs, prefix=""):
        logs = logs or {}
        items = " - ".join(f"{k}: {_fmt(v)}" for k, v in logs.items())
        total = self.steps if self.steps is not None else "?"
        print(f"{prefix}step {step + 1}/{total} - {items}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and (step + 1) % self.log_freq == 0:
            self._log(step, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            self._log(self.steps - 1 if self.steps else 0, logs,
                      prefix=f"[{dt:.2f}s] ")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {_fmt(v)}"
                               for k, v in (logs or {}).items())
            print(f"Eval - {items}")


def _fmt(v):
    try:
        arr = np.asarray(v).ravel()
        if arr.size == 1:
            return f"{float(arr[0]):.4f}"
        return "[" + ", ".join(f"{float(x):.4f}" for x in arr) + "]"
    except Exception:
        return str(v)


class FaultTolerantCheckpoint(Callback):
    """Resumable checkpointing for ``Model.fit``: snapshots model +
    optimizer (incl. the TrainStep's slots and step counter) + RNG +
    epoch/step cursor through a ``CheckpointManager`` (CRC'd atomic files,
    keep-last-N GC, corrupt-file fallback on load), every
    ``save_freq_steps`` train steps and/or at each epoch end. With
    ``preemption_save=True``, SIGTERM triggers one final synchronous save
    before exit.

    Pair with ``Model.fit(..., resume=<dirname>)``: a relaunched job
    restores everything and skips the already-consumed steps of the
    interrupted epoch.

    Training-health guard: while the numerics sentinel is tripped (the
    current weights hold NaN/Inf) periodic and epoch-end saves are SKIPPED
    with a ``health_alert`` event, so the last good checkpoint stays the
    rollback/resume target; a save racing the sentinel's detection latency
    can still capture bad state, and the HealthMonitor rollback walks past
    such files.

    Preemption-save caveat: the step cursor is exact at batch boundaries.
    A SIGTERM that lands INSIDE a train step may snapshot weights that
    already include the in-flight update with a cursor one step behind —
    that batch replays once on resume (at-least-once step semantics).

    Across ranks (``PADDLE_TRAINERS_NUM`` >= 2): ``coordinator="auto"``
    builds a ``CheckpointCoordinator`` from the env contract, so every
    rank publishes step N or none does, and resume negotiates the newest
    step committed on EVERY rank. Pass an explicit coordinator, or
    ``coordinator=None`` / ``PADDLE_TPU_CKPT_BARRIER=0``, to override; one
    host saves plainly. ``layout="sharded"`` writes the chunked shared-
    directory layout (``distributed/sharded_checkpoint.py``), with
    ``async_save`` off the step's path; ``"auto"`` follows what the
    directory holds.

    Generation-resync contract: one aborted coordinated save is tolerated
    (a transiently slow peer), but ``PADDLE_TPU_CKPT_ABORT_EXIT`` (default
    2) CONSECUTIVE aborts raise ``SystemExit(ELASTIC_EXIT_CODE)`` (101),
    which the launcher honors by relaunching the pod. 0 disables it.
    """

    def __init__(self, dirname: str, save_freq_steps: Optional[int] = None,
                 save_freq_epochs: int = 1, keep_last_n: int = 3,
                 async_save: bool = False, preemption_save: bool = True,
                 coordinator="auto", barrier_timeout: Optional[float] = None,
                 layout: str = "auto"):
        super().__init__()
        from ..distributed.checkpoint import (coordinator_from_env,
                                              open_manager)
        if coordinator == "auto":
            coordinator = coordinator_from_env(timeout=barrier_timeout)
        self.manager = open_manager(dirname, layout=layout,
                                    keep_last_n=keep_last_n,
                                    async_save=async_save,
                                    coordinator=coordinator)
        self.save_freq_steps = save_freq_steps
        self.save_freq_epochs = max(1, save_freq_epochs)
        self.preemption_save = preemption_save
        self._epoch = 0
        self._step = -1
        self._global_step = 0
        self._aborted_saves = 0
        # strict: fail at construction with the real cause, not
        # mid-training with an anonymous int() error on the first abort
        from ..utils.envparse import env_int
        self._abort_exit_limit = env_int("PADDLE_TPU_CKPT_ABORT_EXIT", 2,
                                         strict=True)
        self._epoch_done = False
        self._resume_epoch = -1
        self._resume_skip = 0

    # -- state capture -------------------------------------------------------
    def _capture(self):
        from ..framework.random import get_rng_state
        m = self.model
        m._sync_from_train_step()
        # before the first resumed batch the TrainStep is not rebuilt yet:
        # its restored slot state still lives in _pending_ts_state and
        # must survive a preemption save
        ts_state = m._train_step.state_dict() if m._train_step is not None \
            else getattr(m, "_pending_ts_state", None)
        return {
            "network": dict(m.network.state_dict()),
            "optimizer": (m._optimizer.state_dict()
                          if m._optimizer is not None else None),
            "train_step": ts_state,
            "rng": get_rng_state(),
            "epoch": self._epoch,
            "step_in_epoch": self._step + 1,
            "global_step": self._global_step,
            "epoch_done": self._epoch_done,
        }

    def _save(self):
        from ..profiler import health as _health_mod
        if _health_mod.tripped():
            # the sentinel says the CURRENT state holds NaN/Inf: a
            # CRC-valid checkpoint of it would poison the rollback path
            _health_mod.note_alert({"signal": "checkpoint_skipped",
                                    "step": self._global_step})
            from ..profiler import events as _events_mod
            _events_mod.emit("health_alert", severity="warn",
                             signal="checkpoint_skipped",
                             step=int(self._global_step))
            return
        committed = self.manager.save(self._capture(),
                                      step=self._global_step)
        if committed or self.manager.coordinator is None:
            self._aborted_saves = 0
            return
        self._aborted_saves += 1
        limit = self._abort_exit_limit
        if limit > 0 and self._aborted_saves >= limit:
            # persistent barrier aborts mean a rank or a generation is out
            # of step: exit ELASTIC_EXIT_CODE so the launcher relaunches
            # every rank together, instead of training on while no
            # checkpoint is ever published. Uninstall the SIGTERM hook
            # first, so a relaunch in this process does not chain it.
            self.manager.uninstall_preemption_handler()
            from ..distributed.launch import ELASTIC_EXIT_CODE
            raise SystemExit(ELASTIC_EXIT_CODE)

    # -- hooks ---------------------------------------------------------------
    def on_train_begin(self, logs=None):
        resume = self.params.get("resume") or {}
        self._global_step = int(resume.get("global_step", 0))
        self._epoch = int(resume.get("epoch", 0))
        # a preemption BEFORE the first resumed batch must reproduce the
        # loaded cursor, not reset it to step 0 of the epoch
        self._resume_epoch = self._epoch
        self._resume_skip = int(resume.get("skip_steps", 0))
        self._step = self._resume_skip - 1
        if self.preemption_save:
            self.manager.install_preemption_handler(
                self._capture, step_fn=lambda: self._global_step)

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._step = self._resume_skip - 1 \
            if epoch == self._resume_epoch else -1
        self._epoch_done = False

    def on_train_batch_end(self, step, logs=None):
        self._step = step
        self._global_step += 1
        if self.save_freq_steps and \
                self._global_step % self.save_freq_steps == 0:
            self._save()

    def on_epoch_end(self, epoch, logs=None):
        # a mid-epoch stop (num_iters) reaches here too: only mark the
        # epoch consumed when every step of a known-length epoch ran
        steps = self.params.get("steps")
        stopped = getattr(self.model, "stop_training", False)
        self._epoch_done = not stopped or (steps is not None
                                           and self._step + 1 >= steps)
        # honor save_freq_epochs, but never skip the save that preserves a
        # mid-epoch stop's cursor or the final epoch's state
        final = (epoch + 1) >= self.params.get("epochs", epoch + 1)
        if (epoch + 1) % self.save_freq_epochs == 0 or stopped or final:
            self._save()

    def on_train_end(self, logs=None):
        if self.preemption_save:
            self.manager.uninstall_preemption_handler()
        # the async writer is a daemon thread: a trainer exiting right
        # after fit() would reap it mid-write
        self.manager.drain()


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = baseline
        self.stopped_epoch = 0
        self.stop_training = False
        self.save_dir = None  # set from fit params when available

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_train_begin(self, logs=None):
        self.save_dir = self.params.get("save_dir", self.save_dir)

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).ravel()[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True
