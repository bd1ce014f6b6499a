"""One rank of a CPU gang for the port's ring attention, MoE, pipeline
and row-sharded tables (``tests/test_torch_parallel_gang.py``).

Started by ``analytics_zoo_tpu_torch.core.launcher.launch`` (gloo, CPU
tensors) as ``python _torch_parallel_worker.py SPEC OUT``: joins the
process group from the launcher's environment, runs every case of the
JSON file ``SPEC`` in order, each under its own mesh
(``init_orca_context("multihost", mesh_shape=...)``), and writes this
rank's results to ``OUT/r<rank>.pt`` (a dict of case -> dict of numpy
arrays and numbers; ``{"error": ...}`` for a case that raised).  The
inputs and the models' initial variables are the test's, in
``SPEC["inputs"]`` (a ``torch.save`` file of numpy arrays and JAX-layout
variable trees).
"""

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.core.context import (init_orca_context,
                                                  stop_orca_context)
from analytics_zoo_tpu_torch.orca.learn import Estimator
from analytics_zoo_tpu_torch.parallel import (MoE, embedding_row_rules,
                                              pipeline_apply,
                                              ring_self_attention)

BERT_CFG = dict(vocab_size=50, hidden_size=32, n_layers=2, n_heads=4,
                max_position=16, dropout=0.0)


def _np(t):
    return t.detach().float().numpy()


class WithMoE(nn.Module):
    """The JAX tests' ``WithMoE``: one MoE under ``moe``."""

    def __init__(self, d=8, **kw):
        super().__init__()
        self.moe = MoE(d, **kw)

    def forward(self, x):
        return self.moe(x)


class MoEModel(nn.Module):
    """The JAX tests' ``MoEModel``: Dense(16) ``in``, a one-token MoE,
    Dense(2) ``head``."""

    def __init__(self):
        super().__init__()
        self.add_module("in", tnn.Dense(8, 16))
        self.moe = MoE(16, num_experts=2, hidden_mult=1, top_k=1,
                       capacity_factor=2.0)
        self.head = tnn.Dense(16, 2)

    def forward(self, x):
        h = getattr(self, "in")(x)[:, None, :]
        return self.head(self.moe(h)[:, 0])


def _mlp_stage(params, x):
    """The JAX tests' ``_mlp_stage``: Dense(16, relu) then Dense(8)."""
    h = torch.relu(x @ params["fc1"]["kernel"] + params["fc1"]["bias"])
    return h @ params["fc2"]["kernel"] + params["fc2"]["bias"]


def _tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _tree(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def case_ring(case, inp):
    out = {}
    x = inp["ring"]
    for causal in (False, True):
        q, k, v = (torch.tensor(x[n]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        o = ring_self_attention(q, k, v, causal=causal)
        (o * torch.tensor(x["w"])).sum().backward()
        tag = "causal" if causal else "full"
        out[f"{tag}_out"] = _np(o)
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            out[f"{tag}_{n}"] = _np(t.grad)
    return out


def _bert_est(inp, key, **kw):
    from analytics_zoo_tpu_torch.models import BERTClassifier
    model = BERTClassifier(3, use_ring=True, **BERT_CFG)
    model.load_state_dict(from_jax_variables(inp[key]), strict=True)
    return Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                                optimizer="adam", learning_rate=1e-3,
                                device="cpu", **kw)


def case_ring_bert(case, inp):
    est = _bert_est(inp, "bert")
    ids, y = inp["bert_data"]
    hist = est.fit((ids, y), epochs=2, batch_size=8, verbose=False)
    return {"loss": np.asarray(hist["loss"]),
            "communicates": est._scale.communicates,
            "params": est.get_model()["params"]}


def case_seq_labels(case, inp):
    model = tnn.Sequential([tnn.Dense(9, 3)])
    model.load_state_dict(from_jax_variables(inp["seq_labels"]), strict=True)
    est = Estimator.from_keras(model, loss="categorical_crossentropy",
                               learning_rate=0.1, device="cpu")
    x, y = inp["seq_labels_data"]
    hist = est.fit((x, y), epochs=1, batch_size=8, verbose=False)
    return {"loss": np.asarray(hist["loss"])}


def case_moe_forward(case, inp):
    """The expert-split layer against the whole layer in this process:
    its output and every gradient (``wi``/``wo``: this rank's experts)."""
    from analytics_zoo_tpu_torch.core.context import get_mesh
    from analytics_zoo_tpu_torch.parallel.moe import ExpertParallel
    mesh = get_mesh()
    out = {}
    x0 = inp["moe_x"]
    for split in (False, True):
        m = WithMoE(8, num_experts=4, hidden_mult=2, top_k=1,
                    capacity_factor=4.0)
        m.load_state_dict(from_jax_variables(inp["moe"]), strict=True)
        if split:
            m.moe.ep = ExpertParallel(mesh.group(("expert",)),
                                      mesh.shape["expert"],
                                      mesh.index(("expert",)))
        x = torch.tensor(x0).requires_grad_(True)
        y = m(x)
        y.square().sum().backward()
        tag = "split" if split else "whole"
        out[f"{tag}_out"] = _np(y)
        out[f"{tag}_aux"] = float(m.moe.aux_loss)
        out[f"{tag}_dx"] = _np(x.grad)
        for n in ("gate", "wi", "wo"):
            out[f"{tag}_d{n}"] = _np(getattr(m.moe, n).grad)
    return out


def _moe_est(variables=None):
    model = MoEModel()
    if variables is not None:  # before the estimator cuts the experts
        model.load_state_dict(from_jax_variables(variables), strict=True)
    return Estimator.from_keras(model, loss="sparse_categorical_crossentropy",
                                learning_rate=0.05, sharding="tp",
                                device="cpu")


def case_moe_fit(case, inp):
    est = _moe_est(inp["moe_model"])
    x, y = inp["moe_data"]
    hist = est.fit((x, y), epochs=3, batch_size=16, verbose=False)
    out = {"loss": np.asarray(hist["loss"]),
           "wi_shape": list(est.model.moe.wi.shape),
           "params": est.get_model()["params"],
           "aux": float(est.model.moe.aux_loss),
           "ep_layers": est._scale.ep_layers}
    if case.get("save"):
        est.save(case["save"])
        est2 = _moe_est()
        est2.load(case["save"])
        out["loaded_params"] = est2.get_model()["params"]
        out["loaded_step"] = est2._py_step
    return out


def case_pipe(case, inp):
    out = {}
    x0 = inp["pipe_x"]
    for tag, n_micro in case.get("runs", (("s4", 4), ("s2", 2))):
        params = _tree(inp[f"pipe_{tag}"], grad=True)
        y = pipeline_apply(_mlp_stage, params, torch.tensor(x0),
                           n_microbatches=n_micro)
        y.sum().backward()
        out[f"{tag}_out"] = _np(y)
        for layer in ("fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                out[f"{tag}_d{layer}_{leaf}"] = _np(params[layer][leaf].grad)
    for tag, x, n_micro in (("batch", x0[:6], 4), ("stages", x0, 2)):
        if not case.get("errors", True):
            break
        params = _tree(inp["pipe_s3" if tag == "stages" else "pipe_s4"])
        try:
            pipeline_apply(_mlp_stage, params, torch.tensor(x), n_micro)
            out[f"{tag}_error"] = ""
        except ValueError as e:
            out[f"{tag}_error"] = str(e)
    return out


def _ncf(inp, users):
    from analytics_zoo_tpu_torch.models import NeuralCF
    m = NeuralCF(user_count=users, item_count=40, class_num=2, user_embed=8,
                 item_embed=8, hidden_layers=(16, 8), mf_embed=8,
                 sharded_embeddings=True)
    m.load_state_dict(from_jax_variables(inp[f"ncf_{users}"]), strict=True)
    return m


def _tables(model):
    return {n: _np(p) for n, p in model.named_parameters()
            if n.endswith("sharded_embeddings")}


def case_ncf(case, inp):
    users = case["users"]
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-2, seed=7, sharding=embedding_row_rules(),
              device="cpu")
    x, y = inp[f"ncf_data_{users}"]
    model = _ncf(inp, users)
    est = Estimator.from_keras(model, nan_policy="skip_step", **kw)
    hist = est.fit((x, y), epochs=case["epochs"], batch_size=64,
                   verbose=False)
    out = {"loss": np.asarray(hist["loss"]), "bad_steps": est.bad_steps,
           "tables": _tables(model),
           "dense": {n: _np(p) for n, p in model.named_parameters()
                     if not n.endswith("sharded_embeddings")},
           "eval": est.evaluate((x, y), batch_size=64),
           "pred_shape": list(np.asarray(
               est.predict(x[:32], batch_size=32)).shape)}
    if case.get("save"):
        est.save(case["save"])
        est2 = Estimator.from_keras(_ncf(inp, users), **kw)
        est2.load(case["save"])
        out["loaded_tables"] = _tables(est2.model)
        out["loaded_step"] = est2._py_step
    return out


CASES = {"ring": case_ring, "ring_bert": case_ring_bert,
         "seq_labels": case_seq_labels, "moe_forward": case_moe_forward,
         "moe_fit": case_moe_fit, "pipe": case_pipe, "ncf": case_ncf}


def main(spec_path, out_dir):
    # one intra-op thread a rank: tier-1 runs test files side by side
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    inp = torch.load(spec["inputs"], weights_only=False)
    rank = int(os.environ["ZOO_PROCESS_ID"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['ZOO_COORDINATOR']}",
        rank=rank, world_size=int(os.environ["ZOO_NUM_PROCESSES"]))
    results = {}
    for case in spec["cases"]:
        stop_orca_context()
        init_orca_context("multihost", mesh_shape=case["mesh"])
        try:
            results[case["name"]] = CASES[case["kind"]](case, inp)
        except Exception as e:  # recorded: every rank raises alike
            results[case["name"]] = {
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()}
    stop_orca_context()
    torch.save(results, os.path.join(out_dir, f"r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
