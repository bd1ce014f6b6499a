"""Metrics (port of ``analytics_zoo_tpu/nn/metrics.py``).

A metric is a pair of functions, so the estimator can sum statistics over
batches and score a padded last batch exactly:

- ``update(y_pred, y_true, mask=None) -> stats``: per-batch sufficient
  statistics as a tensor (e.g. ``[correct, total]``), summed over batches
  by the estimator.  ``mask`` ``[batch]`` weights each example (0.0 for a
  padding row).
- ``result(stats) -> tensor``: the value from the summed statistics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch


def _ones_mask(y_pred: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones((y_pred.shape[0],), dtype=torch.float32,
                          device=y_pred.device)
    return mask.float()


def _per_example(hit: torch.Tensor) -> torch.Tensor:
    """Multi-position outputs (e.g. ``[B, T]`` token predictions) score each
    example by its fraction of correct positions."""
    return hit.reshape(hit.shape[0], -1).float().mean(dim=-1)


class Metric:
    name: str = "metric"

    def update(self, y_pred: torch.Tensor, y_true: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def result(self, stats: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _Fraction(Metric):
    def result(self, stats):
        return stats[0] / torch.clamp(stats[1], min=1.0)


class Accuracy(_Fraction):
    """argmax accuracy for class outputs; threshold accuracy (logit > 0)
    for 1-d outputs."""

    name = "accuracy"

    def update(self, y_pred, y_true, mask=None):
        m = _ones_mask(y_pred, mask)
        if y_pred.dim() > 1 and y_pred.shape[-1] > 1:
            pred = torch.argmax(y_pred, dim=-1)
            true = (torch.argmax(y_true, dim=-1)
                    if y_true.dim() == y_pred.dim() else y_true)
        else:
            pred = (y_pred.reshape(y_pred.shape[0], -1)[:, 0] > 0).int()
            true = y_true.reshape(y_true.shape[0], -1)[:, 0]
        hit = _per_example(pred.int() == true.int())
        return torch.stack([(hit * m).sum(), m.sum()])


class TopKAccuracy(_Fraction):
    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}_accuracy"

    def update(self, y_pred, y_true, mask=None):
        m = _ones_mask(y_pred, mask)
        # jax.lax.top_k puts the lower index first among equal scores and
        # -0 after +0 (torch.topk leaves ties unordered): a stable sort on
        # the sign of the zeros, then a stable descending one on the
        # scores, does both
        neg_zero = (y_pred == 0) & torch.signbit(y_pred)
        order = torch.sort(neg_zero.to(torch.uint8), dim=-1,
                           stable=True).indices
        ranked = torch.sort(y_pred.gather(-1, order), dim=-1,
                            descending=True, stable=True).indices
        topk = order.gather(-1, ranked[..., :self.k])
        true = (torch.argmax(y_true, dim=-1)
                if y_true.dim() == y_pred.dim() else y_true)
        hit = _per_example((topk == true[..., None].long()).any(dim=-1))
        return torch.stack([(hit * m).sum(), m.sum()])


class _ElementwiseError(_Fraction):
    def _err(self, y_pred, y_true):
        raise NotImplementedError

    def update(self, y_pred, y_true, mask=None):
        m = _ones_mask(y_pred, mask)
        if y_true.shape != y_pred.shape and \
                y_true.numel() == y_pred.numel():
            # [B] labels vs [B, 1] outputs: align rather than broadcast to
            # a [B, B] cross matrix
            y_true = y_true.reshape(y_pred.shape)
        per_elem = self._err(y_pred, y_true).reshape(y_pred.shape[0], -1)
        per_row = per_elem.sum(dim=-1)
        return torch.stack([(per_row * m).sum().float(),
                            m.sum() * per_elem.shape[-1]])


class MeanAbsoluteError(_ElementwiseError):
    name = "mae"

    def _err(self, y_pred, y_true):
        return torch.abs(y_pred - y_true)


class MeanSquaredError(_ElementwiseError):
    name = "mse"

    def _err(self, y_pred, y_true):
        return torch.square(y_pred - y_true)


class BinaryAUC(Metric):
    """AUC from fixed-bin score histograms: ``update`` adds each example's
    weight to the bin of its sigmoid score, ``result`` sweeps thresholds
    from high to low and integrates the ROC curve (trapezoids)."""

    name = "auc"

    def __init__(self, num_bins: int = 200):
        self.num_bins = num_bins

    def update(self, y_pred, y_true, mask=None):
        m = _ones_mask(y_pred, mask)
        # per-example weight broadcast over any extra output dims
        w = m.reshape((-1,) + (1,) * (y_pred.dim() - 1)).expand(
            y_pred.shape).reshape(-1)
        p = torch.clamp(torch.sigmoid(y_pred.reshape(-1).float()), 0.0,
                        1.0 - 1e-7)
        t = y_true.reshape(-1).float()
        bins = torch.floor(p * self.num_bins).long()
        zeros = torch.zeros(self.num_bins, device=y_pred.device)
        pos = zeros.index_add(0, bins, t * w)
        neg = zeros.index_add(0, bins, (1.0 - t) * w)
        return torch.stack([pos, neg])

    def result(self, stats):
        pos, neg = stats[0], stats[1]
        tp = torch.cumsum(pos.flip(0), 0)
        fp = torch.cumsum(neg.flip(0), 0)
        tpr = tp / torch.clamp(tp[-1], min=1.0)
        fpr = fp / torch.clamp(fp[-1], min=1.0)
        zero = torch.zeros(1, device=stats.device)
        return torch.trapezoid(torch.cat([zero, tpr]), torch.cat([zero, fpr]))


METRICS: Dict[str, Callable[[], Metric]] = {
    "accuracy": Accuracy,
    "acc": Accuracy,
    "top5": lambda: TopKAccuracy(5),
    "top5_accuracy": lambda: TopKAccuracy(5),
    "mae": MeanAbsoluteError,
    "mse": MeanSquaredError,
    "auc": BinaryAUC,
}


def get(metric: Union[str, Metric]) -> Metric:
    if isinstance(metric, Metric):
        return metric
    try:
        return METRICS[metric]()
    except KeyError:
        raise ValueError(
            f"unknown metric {metric!r}; known: {sorted(METRICS)}") from None
