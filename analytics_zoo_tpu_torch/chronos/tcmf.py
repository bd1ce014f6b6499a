"""TCMFForecaster (port of ``analytics_zoo_tpu/chronos/tcmf.py``): temporal
convolutional matrix factorization (DeepGLO, Sen et al. 2019).

A panel of series ``Y [n, T]`` is factorized as ``Y ~ F @ X`` with a small
temporal basis ``X [k, T]``; a TCN learns X's dynamics and rolls it
forward; forecasts are ``F @ X_future``.  On ``device`` (``None``: the
card) the factorization is a loop of ``y_iters`` steps over the panel,
both factors updated by the port's optax-layout Adam (``orca/learn/
optimizers.py``, the JAX package's ``optax.adam``), nothing read back
until the loop ends; the TCN trains through the Estimator, and the
rollout is a loop of TCN forwards on the device with one copy to the
host at its end.  ``fit`` also takes an ``XShards`` of ``{"id", "y"}``
panels and ``predict`` then gives per-shard ``{"id", "prediction"}``
XShards, as in the JAX package.

Two things differ from the JAX version.  The initial ``F`` and ``X`` are
drawn from a ``torch.Generator`` seeded with ``seed`` (JAX draws them
from ``jax.random``; ``fit(_init=(F0, X0))`` takes given ones).  And
where the JAX version shards the panel's rows over its mesh's ``data``
axis, the port takes a list of devices (``device=["cuda:0", "cuda:1"]``):
the rows, zero-padded to a multiple of the device count and masked out of
the loss, are split in equal blocks, each block's ``F`` and ``Y`` on its
device; ``X`` lives on the first device and each block's product reads a
copy of it, whose gradients autograd sums back; the TCN trains on the
first device.
``save``/``load`` write and read the JAX package's files (``factors.npz``,
``config.json``, ``shards.json``, the TCN's checkpoint under ``tcn/``),
so either package loads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..orca.learn import Estimator
from ..orca.learn import optimizers as opt_lib
from .forecaster import _TCN, seeded


def _devices(device: Any) -> list:
    """``device`` as a list of devices (one unless a list names more)."""
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device] or [resolve_device(None)]
    return [resolve_device(device)]


class TCMFForecaster:
    def __init__(self, vbsize: int = 128, hbsize: int = 256,
                 num_channels_X: Optional[Sequence[int]] = None,
                 y_iters: int = 300, rank: int = 8, tcn_lookback: int = 16,
                 lam: float = 1e-3, lr: float = 5e-2, tcn_lr: float = 1e-3,
                 seed: int = 0, device: Any = None):
        """``rank``: k, the basis dimension.  vbsize/hbsize are kept for
        reference-API compatibility (batching knobs of the reference's
        torch code; the whole panel trains at once here)."""
        self.devices = _devices(device)
        self.device = self.devices[0]
        self._config = dict(num_channels_X=list(num_channels_X or (16, 16)),
                            y_iters=y_iters, rank=rank,
                            tcn_lookback=tcn_lookback, lam=lam, lr=lr,
                            tcn_lr=tcn_lr, seed=seed)
        self.rank = rank
        self.iters = y_iters
        self.lam = lam
        self.lr = lr
        self.tcn_lr = tcn_lr
        self.tcn_lookback = tcn_lookback
        self.num_channels_x = self._config["num_channels_X"]
        self.seed = seed
        self.F: Optional[np.ndarray] = None      # [n, k]
        self.X: Optional[np.ndarray] = None      # [k, T]
        self._tcn_est: Optional[Any] = None

    def _make_tcn_estimator(self):
        model = seeded(_TCN(self.rank, num_channels=self.num_channels_x,
                            output_dim=self.rank, horizon=1), self.seed)
        return Estimator.from_keras(model, loss="mse",
                                    learning_rate=self.tcn_lr,
                                    seed=self.seed, device=self.device)

    # -- factorization --------------------------------------------------------

    def _factorize(self, y: np.ndarray, init: Optional[Sequence] = None
                   ) -> None:
        n, t = y.shape
        k = self.rank
        if init is None:
            gen = torch.Generator().manual_seed(int(self.seed))
            init = (torch.randn((n, k), generator=gen) * 0.1,
                    torch.randn((k, t), generator=gen) * 0.1)
        f0, x0 = (np.array(a, np.float32) for a in init)
        devices = self.devices
        if len(devices) == 1:
            self._factorize_one(y, f0, x0)
            return
        # the rows in equal blocks a device, padded with zero rows that
        # the mask keeps out of the loss (so they never move)
        dp = len(devices)
        pad = (-n) % dp
        m = (n + pad) // dp
        f0 = np.concatenate([f0, np.zeros((pad, k), np.float32)])
        y_pad = np.concatenate([y, np.zeros((pad, t), np.float32)])
        mask = np.zeros((n + pad, 1), np.float32)
        mask[:n] = 1.0
        fs = [torch.from_numpy(f0[i * m:(i + 1) * m]).to(d).requires_grad_()
              for i, d in enumerate(devices)]
        ys = [torch.from_numpy(y_pad[i * m:(i + 1) * m]).to(d)
              for i, d in enumerate(devices)]
        masks = [torch.from_numpy(mask[i * m:(i + 1) * m]).to(d)
                 for i, d in enumerate(devices)]
        home = devices[0]
        xp = torch.from_numpy(x0).to(home).requires_grad_()
        params = fs + [xp]
        tx = opt_lib.adam(self.lr)
        state = tx.init(params)
        lam = self.lam
        denom_mse, denom_f = float(n * t), float(n * k)
        loss = None
        for _ in range(self.iters):
            sq = f2 = None
            for fp, yd, md, d in zip(fs, ys, masks, devices):
                xd = xp if d == home else xp.to(d)
                a = torch.sum(((fp @ xd - yd) * md) ** 2).to(home)
                b = torch.sum((fp * md) ** 2).to(home)
                sq, f2 = (a, b) if sq is None else (sq + a, f2 + b)
            loss = sq / denom_mse + lam * (f2 / denom_f
                                           + torch.mean(xp ** 2))
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                state = tx.step(params, list(grads), state)
        self.F = np.concatenate([f.detach().cpu().numpy() for f in fs])[:n]
        self.X = xp.detach().cpu().numpy()
        self._factor_loss = float(loss.detach())

    def _factorize_one(self, y: np.ndarray, f0: np.ndarray,
                       x0: np.ndarray) -> None:
        """The factorization on one device."""
        n, t = y.shape
        k = self.rank
        f, x = (torch.from_numpy(a).to(self.device) for a in (f0, x0))
        params = [f.requires_grad_(True), x.requires_grad_(True)]
        yd = torch.as_tensor(y).to(self.device)
        tx = opt_lib.adam(self.lr)
        state = tx.init(params)
        lam = self.lam
        denom_mse, denom_f = float(n * t), float(n * k)
        loss = None
        for _ in range(self.iters):
            fp, xp = params
            mse = torch.sum((fp @ xp - yd) ** 2) / denom_mse
            reg = lam * (torch.sum(fp ** 2) / denom_f + torch.mean(xp ** 2))
            loss = mse + reg
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                state = tx.step(params, list(grads), state)
        self.F = params[0].detach().cpu().numpy()
        self.X = params[1].detach().cpu().numpy()
        self._factor_loss = float(loss.detach())

    # -- public API -----------------------------------------------------------

    def fit(self, x: Any, val_len: int = 0, epochs: int = 5,
            batch_size: int = 64, _init: Optional[Sequence] = None) -> float:
        """``x``: {"y": [n, T] panel}, or an ``XShards`` whose shards are
        such dicts (optionally with "id").  Returns the factorization
        loss."""
        from ..data import XShards

        self._shard_sizes = self._shard_ids = None
        if isinstance(x, XShards):
            parts = x.collect()
            self._shard_sizes = [np.asarray(p["y"]).shape[0] for p in parts]
            self._shard_ids = [p.get("id") for p in parts]
            x = {"y": np.concatenate(
                [np.asarray(p["y"], np.float32) for p in parts])}
        y = np.asarray(x["y"], np.float32)
        if y.ndim != 2:
            raise ValueError(f"y must be [n, T], got {y.shape}")
        if y.shape[1] <= self.tcn_lookback + 1:
            raise ValueError(
                f"series length {y.shape[1]} too short for tcn_lookback="
                f"{self.tcn_lookback}")
        self._factorize(y, _init)
        # train the TCN on the basis: windows of X.T [T, k]
        xt = self.X.T                                     # [T, k]
        look = self.tcn_lookback
        wins = np.stack([xt[i:i + look] for i in
                         range(len(xt) - look)])          # [N, look, k]
        nexts = np.stack([xt[i + look][None] for i in
                          range(len(xt) - look)])         # [N, 1, k]
        self._tcn_est = self._make_tcn_estimator()
        hist = self._tcn_est.fit((wins, nexts), epochs=epochs,
                                 batch_size=min(batch_size, len(wins)),
                                 verbose=False)
        self._tcn_loss = hist["loss"][-1]
        return self._factor_loss

    @torch.no_grad()
    def _roll(self, horizon: int) -> np.ndarray:
        """The basis rolled ``horizon`` steps forward by the TCN: ``[k,
        horizon]``."""
        model = self._tcn_est.model
        was_training = model.training
        model.eval()
        window = torch.as_tensor(np.ascontiguousarray(
            self.X.T[-self.tcn_lookback:], np.float32))[None].to(self.device)
        steps = []
        try:
            for _ in range(horizon):
                nxt = model(window)[:, 0]                 # [1, k]
                window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
                steps.append(nxt[0])
        finally:
            model.train(was_training)
        return torch.stack(steps, dim=1).cpu().numpy()

    def predict(self, horizon: int = 24) -> Any:
        """Roll the basis forward with the TCN; return F @ X_future
        -> [n, horizon] (per-shard XShards after an XShards fit)."""
        if self.F is None or self._tcn_est is None:
            raise ValueError("fit first")
        preds = self.F @ self._roll(horizon)
        if getattr(self, "_shard_sizes", None):
            from ..data import XShards
            out, off = [], 0
            for size, ids in zip(self._shard_sizes, self._shard_ids):
                shard = {"prediction": preds[off:off + size]}
                if ids is not None:
                    shard["id"] = ids
                out.append(shard)
                off += size
            return XShards(out)
        return preds

    def evaluate(self, target_value: Dict[str, np.ndarray],
                 metric=("mae",)) -> Dict[str, float]:
        y = np.asarray(target_value["y"], np.float32)
        pred = self.predict(horizon=y.shape[1])
        if not isinstance(pred, np.ndarray):  # distributed-input mode
            pred = np.concatenate([s["prediction"] for s in pred.collect()])
        err = pred - y
        out = {}
        for m in metric:
            if m == "mae":
                out["mae"] = float(np.mean(np.abs(err)))
            elif m == "mse":
                out["mse"] = float(np.mean(err ** 2))
            else:
                raise ValueError(f"unknown metric {m}")
        return out

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> str:
        if self.F is None:
            raise ValueError("nothing to save: fit first")
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "factors.npz"), F=self.F, X=self.X)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self._config, f)
        if getattr(self, "_shard_sizes", None):
            with open(os.path.join(path, "shards.json"), "w") as f:
                json.dump({"sizes": self._shard_sizes,
                           "ids": [list(i) if i is not None else None
                                   for i in self._shard_ids]}, f)
        self._tcn_est.save(os.path.join(path, "tcn"))
        return path

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TCMFForecaster":
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        fc = TCMFForecaster(device=device, **cfg)
        z = np.load(os.path.join(path, "factors.npz"))
        fc.F, fc.X = z["F"], z["X"]
        shards_file = os.path.join(path, "shards.json")
        if os.path.exists(shards_file):
            with open(shards_file) as f:
                meta = json.load(f)
            fc._shard_sizes, fc._shard_ids = meta["sizes"], meta["ids"]
        fc._tcn_est = fc._make_tcn_estimator()
        fc._tcn_est.load(os.path.join(path, "tcn"))
        return fc
