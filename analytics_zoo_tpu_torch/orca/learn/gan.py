"""GANEstimator: alternating discriminator and generator training (port of
``analytics_zoo_tpu/orca/learn/gan.py``).

The JAX package's contract: losses follow tf.gan's
(``generator_loss(fake_logits)``, ``discriminator_loss(real_logits,
fake_logits)``; the defaults are the non-saturating GAN losses); each
batch takes ``d_steps`` discriminator steps, then ``g_steps`` generator
steps, and the step count counts both.

- A D step runs the generator in eval mode (running statistics, nothing
  updated) on fresh noise, then D in training mode twice, on the real
  batch and on the fakes; the second call sees the batch-norm statistics
  the first one updated (the JAX step threads D's state through both).
  The gradient is D's only.
- A G step runs G in training mode and D in eval mode; the gradient is
  G's only.

The noise is drawn on the device from ``noise_generator``, a
``torch.Generator`` seeded with ``seed``; ``d_step``/``g_step`` also take
the noise as an argument (the tests feed the JAX package's
``normal(fold_in(rng, step))``).  On the card each step kind is a replay
of one CUDA graph a batch key, captured through the Estimator's
``_StepGraph`` (the counterpart of the JAX ``jax.jit`` of each step): the
first step of a key runs eagerly, then the same step is captured with the
noise and dropout generators registered, so a captured ``fit`` gives the
eager one's losses.  ``cuda_graphs=False`` runs the card eagerly.

``save``/``load`` write and read ``core/checkpoint.py``'s format with the
JAX GANEstimator's tree (``g_params``, ``g_state``, ``d_params``,
``d_state``, ``g_opt``, ``d_opt`` in optax's layout, ``rng``, ``step``), so
a checkpoint of either package loads in the other.  The port's noise
generator state rides in the checkpoint's ``extra``, which the JAX load
does not read; ``rng`` is kept as loaded (the JAX key) and is
``PRNGKey(seed)``'s layout for a fresh port GAN.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import DeviceLike, resolve_device
from ...convert import buffer_names, from_jax_variables, jax_tree, \
    jax_variables
from ...core import checkpoint as ckpt_io
from ...data.feed import as_feed, leaves
from ...nn.layers import Dropout, _indexed, seed_dropout
from . import optimizers as opt_lib
from .estimator import ZooEstimator, _StepGraph, _structure

logger = logging.getLogger("analytics_zoo_tpu_torch")


def non_saturating_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return F.softplus(-fake_logits).mean()


def non_saturating_discriminator_loss(real_logits: torch.Tensor,
                                      fake_logits: torch.Tensor
                                      ) -> torch.Tensor:
    return F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()


class _Side:
    """One step kind as ``_StepGraph`` drives it: its device, step
    function, memory pool and the generators a replay must advance."""

    augment = None

    def __init__(self, gan: "GANEstimator", step: Callable):
        self.device = gan.device
        self._step = step
        self._pool = None
        self._gan = gan

    def _generators_list(self) -> List[torch.Generator]:
        return self._gan._generators()


class GANEstimator:
    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 generator_loss: Callable = non_saturating_generator_loss,
                 discriminator_loss: Callable =
                 non_saturating_discriminator_loss,
                 generator_optimizer: Any = "adam",
                 discriminator_optimizer: Any = "adam",
                 generator_lr: float = 1e-4,
                 discriminator_lr: float = 1e-4,
                 noise_dim: int = 64, d_steps: int = 1, g_steps: int = 1,
                 seed: int = 0, device: DeviceLike = None,
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        self.g_loss_fn = generator_loss
        self.d_loss_fn = discriminator_loss
        self.g_tx = opt_lib.get(generator_optimizer, generator_lr, None)
        self.d_tx = opt_lib.get(discriminator_optimizer, discriminator_lr,
                                None)
        self.noise_dim = noise_dim
        self.d_steps = d_steps
        self.g_steps = g_steps
        self.seed = seed
        self.step = 0
        self._g_names = [n for n, _ in generator.named_parameters()]
        self._d_names = [n for n, _ in discriminator.named_parameters()]
        self._g_params = list(generator.parameters())
        self._d_params = list(discriminator.parameters())
        self._g_opt: Any = None
        self._d_opt: Any = None
        dev = _indexed(self.device)
        self.noise_generator = torch.Generator(device=dev).manual_seed(
            int(seed))
        seed_dropout(self.generator, seed, self.device)
        seed_dropout(self.discriminator, seed + 1, self.device)
        seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._rng = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._sides = {"d": _Side(self, self._d_step),
                       "g": _Side(self, self._g_step)}
        self._graphs: Dict[tuple, _StepGraph] = {}
        #: captures made, one per (step kind, batch key)
        self.capture_count = 0

    # -- steps ----------------------------------------------------------------

    def _generators(self) -> List[torch.Generator]:
        """The card's generators a step draws from: the noise generator
        and the two models' dropout generators (each once)."""
        gens = {id(self.noise_generator): self.noise_generator}
        for model in (self.generator, self.discriminator):
            for m in model.modules():
                if isinstance(m, Dropout) and m.generator is not None:
                    gens[id(m.generator)] = m.generator
        return [g for g in gens.values() if g.device.type == "cuda"]

    def _noise(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "noise" in batch:
            return batch["noise"]
        return torch.randn((batch["x"].shape[0], self.noise_dim),
                           generator=self.noise_generator,
                           device=batch["x"].device)

    def _ensure_opt(self) -> None:
        """Each side's optimizer state, its parameters named by their
        paths in the JAX tree (LARS and LAMB exclude leaves by path)."""
        if self._g_opt is None:
            self._g_opt = self.g_tx.init(
                self._g_params, [n.replace(".", "/") for n in self._g_names])
        if self._d_opt is None:
            self._d_opt = self.d_tx.init(
                self._d_params, [n.replace(".", "/") for n in self._d_names])

    def _d_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        noise = self._noise(batch)
        self.generator.eval()
        self.discriminator.train()
        with torch.no_grad():
            fake = self.generator(noise)
        real_logits = self.discriminator(batch["x"])
        fake_logits = self.discriminator(fake)
        loss = self.d_loss_fn(real_logits, fake_logits)
        grads = torch.autograd.grad(loss, self._d_params, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, self._d_params)]
            self._d_opt = self.d_tx.step(self._d_params, grads, self._d_opt)
        return loss.detach()

    def _g_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        noise = self._noise(batch)
        self.generator.train()
        self.discriminator.eval()
        fake_logits = self.discriminator(self.generator(noise))
        loss = self.g_loss_fn(fake_logits)
        grads = torch.autograd.grad(loss, self._g_params, allow_unused=True)
        with torch.no_grad():
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, self._g_params)]
            self._g_opt = self.g_tx.step(self._g_params, grads, self._g_opt)
        return loss.detach()

    def _run(self, kind: str, real: Any,
             noise: Optional[Any]) -> torch.Tensor:
        """One step of ``kind`` ("d" or "g"); on the card a replay of its
        key's graph (the first step of a key eagerly, then captured)."""
        self._ensure_opt()
        batch = {"x": torch.as_tensor(real, device=self.device)}
        if noise is not None:
            batch["noise"] = torch.as_tensor(noise, device=self.device,
                                             dtype=torch.float32)
        side = self._sides[kind]
        if not self.cuda_graphs:
            loss = side._step(batch)
        else:
            flat = leaves(batch)
            key = (kind, _structure(batch),
                   tuple((tuple(t.shape), t.dtype) for t in flat))
            graph = self._graphs.get(key)
            if graph is None:
                with ZooEstimator._device_lock:
                    graph = _StepGraph(side, batch, flat)
                self._graphs[key] = graph
                self.capture_count += 1
                loss = graph.first_loss
            else:
                graph.load(flat)
                loss = graph.replay().clone()
        self.step += 1
        return loss

    def d_step(self, real: Any, noise: Optional[Any] = None) -> torch.Tensor:
        """One discriminator step on the batch ``real``; ``noise``
        ``[batch, noise_dim]`` replaces the generator's draw.  Returns the
        loss on the device."""
        return self._run("d", real, noise)

    def g_step(self, real: Any, noise: Optional[Any] = None) -> torch.Tensor:
        """One generator step (``real`` gives the batch size only)."""
        return self._run("g", real, noise)

    # -- API ------------------------------------------------------------------

    def fit(self, data: Any, epochs: int = 1, batch_size: int = 32,
            verbose: bool = True) -> Dict[str, List[float]]:
        """``data``: real samples (array, ``(x,)`` tuple, dict or feed).
        A padded, masked tail batch is skipped; the losses are read back
        once an epoch."""
        with ZooEstimator._device_lock:
            feed = as_feed(data, batch_size, seed=self.seed)
            history: Dict[str, List[float]] = {"d_loss": [], "g_loss": []}
            for epoch in range(epochs):
                d_losses: List[torch.Tensor] = []
                g_losses: List[torch.Tensor] = []
                n_batches = 0
                for batch in feed.epoch(self.device, epoch):
                    if "mask" in batch:
                        continue
                    n_batches += 1
                    for _ in range(self.d_steps):
                        d_losses.append(self.d_step(batch["x"]))
                    for _ in range(self.g_steps):
                        g_losses.append(self.g_step(batch["x"]))
                if n_batches == 0:
                    raise ValueError(
                        "epoch produced no full batches: dataset smaller "
                        f"than batch_size={batch_size} (masked tail batches "
                        "are skipped in training) - lower batch_size or add "
                        "data")
                history["d_loss"].append(
                    float(torch.stack(d_losses).float().mean())
                    if d_losses else float("nan"))
                history["g_loss"].append(
                    float(torch.stack(g_losses).float().mean())
                    if g_losses else float("nan"))
                if verbose:
                    logger.info("epoch %d: d_loss=%.4f g_loss=%.4f",
                                epoch + 1, history["d_loss"][-1],
                                history["g_loss"][-1])
            return history

    def generate(self, n: int, seed: Optional[int] = None) -> np.ndarray:
        """``n`` samples of the generator (eval mode) from noise seeded
        with ``seed`` (default ``seed + 1``)."""
        gen = torch.Generator(device=_indexed(self.device)).manual_seed(
            int(self.seed + 1 if seed is None else seed))
        noise = torch.randn((n, self.noise_dim), generator=gen,
                            device=self.device)
        self.generator.eval()
        with torch.no_grad():
            out = self.generator(noise)
        return out.float().cpu().numpy()

    # -- state ----------------------------------------------------------------

    def _tree(self) -> Dict[str, Any]:
        """The JAX GANEstimator's train state over the live tensors."""
        self._ensure_opt()
        g = jax_variables(self.generator.state_dict(),
                          buffer_names(self.generator))
        d = jax_variables(self.discriminator.state_dict(),
                          buffer_names(self.discriminator))
        g_opt = self.g_tx.optax_state(
            self._g_params, self._g_opt,
            lambda ts: jax_tree(zip(self._g_names, ts)))
        d_opt = self.d_tx.optax_state(
            self._d_params, self._d_opt,
            lambda ts: jax_tree(zip(self._d_names, ts)))
        return {"g_params": g["params"], "g_state": g["state"],
                "d_params": d["params"], "d_state": d["state"],
                "g_opt": g_opt, "d_opt": d_opt, "rng": self._rng,
                "step": np.asarray(self.step, np.int32)}

    def save(self, path: str) -> str:
        with ZooEstimator._device_lock:
            tree = self._tree()
            tree["g_opt"] = opt_lib.snapshot(tree["g_opt"])
            tree["d_opt"] = opt_lib.snapshot(tree["d_opt"])
            state = self.noise_generator.get_state().tolist()
            return ckpt_io.save(path, tree, step=self.step,
                                extra={"noise_generator": state})

    def load(self, path: str, example_x: Any = None) -> None:
        """Load a checkpoint of either package in place (``example_x`` is
        the JAX signature's; the port's models hold their shapes)."""
        with ZooEstimator._device_lock:
            saved = ckpt_io.restore(path)
            live = self._tree()
            if ckpt_io.leaf_paths(
                    {k: saved[k] for k in ("g_params", "g_state",
                                           "d_params", "d_state")}) != \
                    ckpt_io.leaf_paths({k: live[k] for k in (
                        "g_params", "g_state", "d_params", "d_state")}):
                raise ValueError("checkpoint does not match this GAN's "
                                 "architecture/optimizers")
            self.generator.load_state_dict(from_jax_variables(
                {"params": saved["g_params"],
                 "state": saved.get("g_state") or {}}), strict=True)
            self.discriminator.load_state_dict(from_jax_variables(
                {"params": saved["d_params"],
                 "state": saved.get("d_state") or {}}), strict=True)
            opt_lib.load_optax(live["g_opt"], saved["g_opt"])
            opt_lib.load_optax(live["d_opt"], saved["d_opt"])
            self.step = int(np.asarray(saved["step"]))
            self._rng = np.asarray(saved["rng"], np.uint32)
            state = ckpt_io.load_extra(path).get("noise_generator")
            cur = self.noise_generator.get_state()
            if state is not None and len(state) == cur.numel():
                self.noise_generator.set_state(
                    torch.tensor(state, dtype=torch.uint8))
            else:
                self.noise_generator.manual_seed(int(self.seed))


__all__ = ["GANEstimator", "non_saturating_discriminator_loss",
           "non_saturating_generator_loss"]
