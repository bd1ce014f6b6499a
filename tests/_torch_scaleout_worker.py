"""One rank of a CPU gang for the port's multi-process tests.

Started by ``analytics_zoo_tpu_torch.core.launcher.launch`` (gloo, CPU
tensors) as ``python _torch_scaleout_worker.py CASES OUT``: joins the
process group from the launcher's environment, then runs every case of
the JSON file ``CASES`` in order, each under its own mesh
(``init_orca_context("multihost", mesh_shape=...)`` after
``stop_orca_context``; the process group outlives the contexts), and
writes this rank's results to ``OUT/r<rank>.json``.

A case: ``{"name", "model": "mlp" | "bn", "mesh", "sharding",
"grad_compression", "epochs", "save": dir | null, "load": dir | null,
"more_epochs": n, "nan_policy", "model_dir", "nan_at": k}`` (``nan_at``
poisons the batch of step k + 1 on every rank, and saves every epoch).  The models start from the variables the test wrote
(``INIT/<model>``, the JAX Estimator's init through the port's checkpoint
format); the data are the JAX tests' ``_data()``.
"""

import json
import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core.context import (init_orca_context,
                                                  stop_orca_context)
from analytics_zoo_tpu_torch.orca.learn import Estimator


class MLP(nn.Module):
    """The JAX tests' ``_mlp()``: ffn1 (8 -> 32, relu), ffn2 (32 -> 4)."""

    def __init__(self, bn: bool = False):
        super().__init__()
        self.ffn1 = tnn.Dense(8, 32, activation=None if bn else "relu")
        if bn:
            self.bn = tnn.BatchNormalization(32)
        self.ffn2 = tnn.Dense(32, 4)

    def forward(self, x):
        h = self.ffn1(x)
        if hasattr(self, "bn"):
            h = torch.relu(self.bn(h))
        return self.ffn2(h)


BERT_CFG = dict(vocab_size=50, hidden_size=32, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)


def data(n=64, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def bert_data(n=32, seq=16, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, BERT_CFG["vocab_size"], (n, seq)).astype(
        np.int32), rng.integers(0, 3, n).astype(np.int32))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().tolist()
    return np.asarray(tree, np.float64).tolist()


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def make(case, init_dir):
    if case.get("model") == "bert":
        from analytics_zoo_tpu_torch.models import BERTClassifier
        model = BERTClassifier(3, **BERT_CFG)
    else:
        model = MLP(bn=case.get("model") == "bn")
    init = ckpt_io.restore(os.path.join(init_dir, case.get("model", "mlp")))
    model.load_state_dict(from_jax_variables(init), strict=True)
    return Estimator.from_keras(
        model, loss="sparse_categorical_crossentropy",
        optimizer=case.get("optimizer", "sgd"),
        learning_rate=case.get("lr", 0.1), seed=1,
        device="cpu", sharding=case.get("sharding", "dp"),
        grad_compression=case.get("grad_compression"),
        nan_policy=case.get("nan_policy"), model_dir=case.get("model_dir"))


def run_case(case, init_dir):
    stop_orca_context()
    mesh = init_orca_context("multihost", mesh_shape=case["mesh"])
    warn = _Warnings()
    logging.getLogger("analytics_zoo_tpu_torch").addHandler(warn)
    metrics_lib.get_registry().reset()
    try:
        est = make(case, init_dir)
        if case.get("load"):
            est.load(case["load"])
        fit_kw = {}
        if case.get("nan_at") is not None:
            # every rank poisons the same step: the global loss is NaN on
            # all of them, and all roll back together
            from analytics_zoo_tpu_torch.core import faults
            faults.get_registry().enable("step.nan", times=1,
                                         after=case["nan_at"])
            fit_kw["checkpoint_trigger"] = "every_epoch"
        xy, batch = ((bert_data(), 8) if case.get("model") == "bert"
                     else (data(), 32))
        hist = est.fit(xy, epochs=case.get("epochs", 2), batch_size=batch,
                       verbose=False, **fit_kw)
        out = {"loss": hist["loss"], "mesh": mesh.shape, "rank": mesh.rank,
               "backend": mesh.backend,
               "eval": est.evaluate(xy, batch_size=batch),
               "pred": est.predict(xy[0], batch_size=batch).tolist(),
               "params": _np(est.get_model()["params"]),
               "state": _np(est.get_model()["state"]),
               "snapshot": {k: v for k, v in
                            metrics_lib.get_registry().snapshot().items()
                            if k.startswith("train.")},
               "warnings": list(warn.messages),
               "bad_steps": est.bad_steps, "rollbacks": est._rollbacks}
        if est._scale is not None:
            out["specs"] = [list(s) for s in est._scale.specs]
            out["sharded"] = est._scale.sharded
            out["opt_piece_shapes"] = [list(p.shape)
                                       for p in est._scale.opt_params]
            out["tp_layers"] = est._scale.tp_layers
            if est._scale.ef is not None:
                out["ef"] = [_np(e) for e in est._scale.ef]
        if case.get("save"):
            est.save(case["save"])
        if case.get("more_epochs"):
            out["more_loss"] = est.fit(data(), epochs=case["more_epochs"],
                                       batch_size=32, verbose=False)["loss"]
        return out
    finally:
        logging.getLogger("analytics_zoo_tpu_torch").removeHandler(warn)


def main(cases_path, out_dir):
    # one intra-op thread a rank: tier-1 runs test files side by side on a
    # few cores, and a gang of 4 ranks must not crowd the others out
    torch.set_num_threads(1)
    with open(cases_path) as f:
        spec = json.load(f)
    init_dir = spec["init"]
    rank = int(os.environ["ZOO_PROCESS_ID"])
    # the process group outlives the cases' contexts
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['ZOO_COORDINATOR']}",
        rank=rank, world_size=int(os.environ["ZOO_NUM_PROCESSES"]))
    results = {}
    for case in spec["cases"]:
        try:
            results[case["name"]] = run_case(case, init_dir)
        except Exception as e:  # recorded: every rank raises alike
            results[case["name"]] = {"error": f"{type(e).__name__}: {e}"}
    stop_orca_context()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(results, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
