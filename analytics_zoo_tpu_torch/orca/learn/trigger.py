# Port of analytics_zoo_tpu/orca/learn/trigger.py (no JAX in it: a copy).
"""Triggers controlling periodic actions during fit.

Reference: BigDL triggers wrapped by Orca (pyzoo/zoo/orca/learn/trigger.py):
``EveryEpoch``, ``SeveralIteration``.
"""

from __future__ import annotations


class Trigger:
    def fires(self, *, step: int, epoch_end: bool) -> bool:
        raise NotImplementedError

    @staticmethod
    def get(t: "Trigger | str | None") -> "Trigger | None":
        if t is None or isinstance(t, Trigger):
            return t
        if t == "every_epoch":
            return EveryEpoch()
        raise ValueError(f"unknown trigger {t!r}")


class EveryEpoch(Trigger):
    def fires(self, *, step: int, epoch_end: bool) -> bool:
        return epoch_end


class SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = int(interval)

    def fires(self, *, step: int, epoch_end: bool) -> bool:
        return step > 0 and step % self.interval == 0
