"""paddle_tpu_torch.metric — model metrics (counterpart of
``paddle_tpu/metric``; its reference is ``python/paddle/metric/
metrics.py``). The metrics compute on the host with numpy, as the
reference's do; tensors from the card are fetched first."""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = topk_idx == label_np[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct):
        correct_np = _np(correct)
        n = correct_np.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            c = correct_np[..., :k].sum()
            self.total[i] += float(c)
            self.count[i] += n
            accs.append(float(c) / n)
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        l = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over descending thresholds
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
            else float(np.trapz(tpr, fpr))


def accuracy(input, label, k=1):
    pred = _np(input)
    lab = _np(label)
    if lab.ndim == pred.ndim and lab.shape[-1] == 1:
        lab = lab[..., 0]
    topk_idx = np.argsort(-pred, axis=-1)[..., :k]
    correct = (topk_idx == lab[..., None]).any(axis=-1)
    return torch.tensor(float(correct.mean()), dtype=torch.float32)
