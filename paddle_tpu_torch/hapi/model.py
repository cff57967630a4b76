"""hapi.Model — the Keras-like training API (counterpart of
``paddle_tpu/hapi/model.py``).

``prepare``/``fit``/``evaluate``/``predict``, the single-batch
``train_batch``/``eval_batch``/``predict_batch``, ``save``/``load`` and
``summary``, as in the reference. Training runs through
``jit.TrainStep`` built with no ``amp_dtype`` (fp32, as the reference's
``Model`` builds it) and ``health=None`` (the sentinel follows
``PADDLE_TPU_HEALTH`` and ``FLAGS_check_nan_inf``). Batches from the
loader are moved to the network's device. ``fit(resume=dir)`` restores
the newest valid ``FaultTolerantCheckpoint`` snapshot and skips the
consumed steps of the interrupted epoch.

With ``PADDLE_TPU_METRICS_PORT`` set, ``fit`` starts the observability
server (``profiler/server.py``: /metrics, /snapshot, /healthz, /events,
/profile) and notes every step for its liveness and its captures.
"""
from __future__ import annotations

import inspect
import os
import warnings
from typing import List

import numpy as np
import torch

from ..framework import io as io_mod
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _load_network_state(network: torch.nn.Module, state: dict) -> None:
    """Copy a state dict (tensors or numpy arrays, any device and type)
    into ``network``'s parameters and buffers, strictly by name."""
    sd = {k: v if isinstance(v, torch.Tensor)
          else torch.from_numpy(np.array(v)) for k, v in state.items()}
    with torch.no_grad():
        network.load_state_dict(sd, strict=True)


class Model:
    """Model(network, inputs=None, labels=None)."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._pending_ts_state = None
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _to_device(self, xs):
        dev = self._device
        return [x.to(dev) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    # -- prepare -------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            assert isinstance(m, Metric), f"{m} is not a paddle Metric"
        self._train_step = None
        return self

    # -- single-batch APIs ---------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        assert self._loss is not None and self._optimizer is not None, \
            "call prepare(optimizer, loss) first"
        if not update:
            raise NotImplementedError(
                "update=False (grad accumulation) is not supported by the "
                "train step, as in the reference")
        inputs = self._to_device(_to_list(inputs))
        labels = self._to_device(_to_list(labels))
        self.network.train()
        if self._train_step is None:
            from ..jit import TrainStep
            loss_fn = self._loss
            self._train_step = TrainStep(
                self.network, lambda out, y: _apply_loss(loss_fn, out, y),
                self._optimizer)
            if self._pending_ts_state is not None:
                self._train_step.set_state_dict(self._pending_ts_state)
                self._pending_ts_state = None
        loss = float(self._train_step(*inputs, *labels))
        # the loss is on the host, so the step's sentinel vector has landed:
        # decode it now, for the callbacks of this step
        self._train_step.flush_health()
        return [loss]

    def eval_batch(self, inputs, labels=None):
        inputs = self._to_device(_to_list(inputs))
        labels = self._to_device(_to_list(labels))
        self.network.eval()
        with torch.no_grad():
            outputs = self.network(*inputs)
            losses = []
            if self._loss is not None and labels:
                losses = [float(_apply_loss(self._loss, outputs, labels[0]))]
        outs = _to_list(outputs)
        metrics = []
        for m in self._metrics:
            # paddle Metric protocol: compute(pred, label) -> update(state)
            state = m.compute(*outs, *labels)
            m.update(*_to_list(state) if isinstance(state, tuple)
                     else [state])
            metrics.append(m.accumulate())
        return (losses, metrics) if self._metrics else losses

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            out = self.network(*self._to_device(_to_list(inputs)))
        return [_host_array(o) for o in _to_list(out)]

    # -- fit/evaluate/predict ------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1,
            epochs=1, eval_freq=1, log_freq=10, save_dir=None,
            save_freq=1, verbose=2, drop_last=False, shuffle=True,
            num_workers=0, callbacks=None, accumulate_grad_batches=1,
            num_iters=None, resume=None):
        """`resume`: a checkpoint directory (or CheckpointManager) written
        by a `FaultTolerantCheckpoint` callback. Restores model weights,
        optimizer slots (incl. the TrainStep state), LR scheduler, RNG,
        and the epoch/step cursor from the newest VALID checkpoint, then
        skips the already-consumed steps of the interrupted epoch. With no
        checkpoint found (fresh job), training starts from scratch."""
        # observability plane: with PADDLE_TPU_METRICS_PORT set, /metrics,
        # /snapshot, /healthz, /events and /profile go live for this job
        from ..profiler import server as _obs_server
        _obs_server.maybe_start_server()
        train_loader = _as_loader(train_data, batch_size, shuffle, drop_last,
                                  num_workers)
        eval_loader = _as_loader(eval_data, batch_size, False, False,
                                 num_workers) if eval_data is not None \
            else None

        from ..io import DataLoader as _DataLoader
        resume_info = self._restore_for_resume(resume, callbacks) \
            if resume else None
        if resume_info and resume_info["skip_steps"] and shuffle and \
                not isinstance(train_data, _DataLoader):
            warnings.warn(
                "fit(resume=...) is skipping mid-epoch steps with "
                "shuffle=True: the resumed epoch's shuffle order is not "
                "reproducible, so the skipped prefix may not match what "
                "was trained before the interruption. Use shuffle=False "
                "(or a deterministic batch_sampler) for exact step-level "
                "resume; epoch-level state is exact either way.")

        cbks = CallbackList(_to_list(callbacks))
        if verbose and not any(isinstance(c, ProgBarLogger)
                               for c in cbks.callbacks):
            cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbks.set_model(self)
        steps = _try_len(train_loader)
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose, "save_dir": save_dir,
                         "resume": resume_info or {},
                         "metrics": ["loss"] + [
                             m.name() for m in self._metrics]})

        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "accumulate_grad_batches: not supported by the train step, "
                "as in the reference")
        self.stop_training = False
        cbks.on_train_begin()
        start_epoch, skip_steps, it = 0, 0, 0
        if resume_info:
            start_epoch = resume_info["epoch"]
            skip_steps = resume_info["skip_steps"]
            it = resume_info["global_step"]
        logs = {}
        for epoch in range(start_epoch, epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                if self.stop_training:
                    break  # a callback (HealthMonitor halt, EarlyStopping)
                    # stopped the run mid-epoch
                if epoch == start_epoch and step < skip_steps:
                    continue  # consumed before the interruption
                inputs, labels = _split_batch(batch)
                cbks.on_train_batch_begin(step)
                loss = self.train_batch(inputs, labels)
                logs = {"loss": loss}
                cbks.on_train_batch_end(step, logs)
                it += 1
                _obs_server.note_step(it)  # /healthz liveness, /profile
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                # eval runs the network: pull trained weights first
                self._sync_from_train_step()
                cbks.on_eval_begin()
                eval_logs = self._run_eval(eval_loader, cbks)
                cbks.on_eval_end(eval_logs)
        cbks.on_train_end(logs)
        self._sync_from_train_step()
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        self._sync_from_train_step()
        loader = _as_loader(eval_data, batch_size, False, False, num_workers)
        cbks = CallbackList(_to_list(callbacks))
        cbks.set_model(self)
        cbks.on_eval_begin()
        logs = self._run_eval(loader, cbks)
        cbks.on_eval_end(logs)
        return logs

    def _run_eval(self, loader, cbks):
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            inputs, labels = _split_batch(batch)
            cbks.on_eval_batch_begin(step)
            r = self.eval_batch(inputs, labels)
            loss = r[0] if isinstance(r, tuple) else r
            if loss:
                losses.append(loss[0])
            cbks.on_eval_batch_end(step, {"loss": loss})
        logs = {}
        if losses:
            logs["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        self._sync_from_train_step()
        loader = _as_loader(test_data, batch_size, False, False, num_workers)
        n_in = _forward_arity(self.network)
        outputs = []
        for batch in loader:
            inputs, _ = _split_batch(batch, has_labels=False)
            if n_in is not None and len(inputs) > n_in:
                inputs = inputs[:n_in]  # dataset yields (inputs, labels)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, training: bool = True):
        self._sync_from_train_step()
        io_mod.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            opt_sd = self._optimizer.state_dict()
            # the TrainStep's slots live in TrainStep.opt_state, not in the
            # eager optimizer — persist them so resume keeps the moments
            if self._train_step is not None:
                opt_sd["__compiled__"] = self._train_step.state_dict()
            io_mod.save(opt_sd, path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer=False):
        _load_network_state(self.network, io_mod.load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt_sd = io_mod.load(path + ".pdopt")
            self._pending_ts_state = opt_sd.pop("__compiled__", None)
            self._optimizer.set_state_dict(opt_sd)
        self._train_step = None
        return self

    def parameters(self, *a, **kw):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        lines = [f"Model: {type(self.network).__name__}"]
        total = 0
        for k, p in self.network.named_parameters():
            n = int(np.prod(p.shape)) if p.shape else 1
            total += n
            lines.append(f"  {k:50s} {str(tuple(p.shape)):20s} {n}")
        lines.append(f"Total params: {total}")
        print("\n".join(lines))
        return {"total_params": total}

    def _sync_from_train_step(self):
        if self._train_step is not None:
            self._train_step.sync_to_layer()

    def _restore_blob(self, blob: dict) -> None:
        """Load one FaultTolerantCheckpoint snapshot into the live model:
        network, optimizer, the TrainStep's slots and step count (applied
        when the step is rebuilt on the next batch) and the RNG. Shared by
        ``fit(resume=)`` and the HealthMonitor rollback, so both restore
        the same state."""
        from ..framework.random import set_rng_state
        _load_network_state(self.network, blob["network"])
        if blob.get("optimizer") is not None and self._optimizer is not None:
            self._optimizer.set_state_dict(blob["optimizer"])
        self._pending_ts_state = blob.get("train_step")
        self._train_step = None
        if blob.get("rng") is not None:
            set_rng_state(blob["rng"])

    def _restore_for_resume(self, resume, callbacks=None):
        """Restore from the newest valid FaultTolerantCheckpoint snapshot.
        Returns {"epoch", "skip_steps", "global_step"} or None (no valid
        checkpoint — fresh start). A FaultTolerantCheckpoint callback
        pointed at the same directory lends its manager."""
        from ..distributed.checkpoint import (CheckpointManager,
                                              coordinator_from_env,
                                              open_manager)
        from .callbacks import FaultTolerantCheckpoint
        mgr = resume if isinstance(resume, CheckpointManager) else None
        if mgr is None:
            for c in _to_list(callbacks):
                if isinstance(c, FaultTolerantCheckpoint) and \
                        os.path.abspath(c.manager.dirname) == \
                        os.path.abspath(str(resume)):
                    mgr = c.manager
                    break
        if mgr is None:
            mgr = open_manager(str(resume),
                               coordinator=coordinator_from_env())
        found = mgr.load_latest()
        if found is None:
            return None
        blob, _ = found
        self._restore_blob(blob)
        epoch = int(blob.get("epoch", 0))
        skip = int(blob.get("step_in_epoch", 0))
        if blob.get("epoch_done"):
            epoch, skip = epoch + 1, 0
        return {"epoch": epoch, "skip_steps": skip,
                "global_step": int(blob.get("global_step", 0))}


def _host_array(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _apply_loss(loss_fn, outputs, labels):
    out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
    if callable(loss_fn):
        return loss_fn(out, labels)
    raise TypeError(f"bad loss {loss_fn!r}")


def _split_batch(batch, has_labels=True):
    if isinstance(batch, (list, tuple)):
        if has_labels and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return list(batch), []
    return [batch], []


def _as_loader(data, batch_size, shuffle, drop_last, num_workers):
    from ..io import DataLoader
    if data is None:
        return None
    if isinstance(data, DataLoader):
        return data
    return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, num_workers=num_workers)


def _forward_arity(network):
    """Number of positional inputs forward accepts, None if *args."""
    try:
        sig = inspect.signature(network.forward)
    except (TypeError, ValueError):
        return None
    n = 0
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            return None
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n += 1
    return n


def _try_len(loader):
    try:
        return len(loader)
    except TypeError:
        return None
