"""Worker of the port's multi-process test (``tests/test_torch_gang.py``),
run through the port's ``zoo-launch`` on CPU ranks over gloo: the twin of
``tests/multihost_worker.py``.

- ``init_orca_context("multihost")`` from the ZOO_* environment;
- the whole dataset in every process, each rank taking its rows of each
  global batch (the port's contract; the JAX worker hands each process its
  own slice);
- fsdp: the kernels' optimizer state as this rank's pieces;
- evaluate's metrics global (the same on every process);
- the collective sharded checkpoint, restored by a fresh estimator.

Prints "MULTIHOST_OK <eval loss>" from every process on success and
writes this rank's trained parameters to ``<ckpt>/../params_p<rank>.npz``.
"""

import os
import sys

import numpy as np


def main() -> None:
    ckpt_dir = sys.argv[1]
    import torch

    torch.set_num_threads(1)  # a rank of a gang beside other test files
    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.core.context import init_orca_context
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    expected = int(os.environ.get("ZOO_NUM_PROCESSES", "2"))
    mesh = init_orca_context("multihost", mesh_shape={"data": 1, "fsdp": 0})
    assert mesh.size == expected, mesh
    torch.manual_seed(0)

    def model():
        m = tnn.Sequential([tnn.Dense(8, 32, activation="relu"),
                            tnn.Dense(32, 32, activation="relu"),
                            tnn.Dense(32, 2)])
        torch.manual_seed(0)
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.3)
        return m

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    est = Estimator.from_keras(model(),
                               loss="sparse_categorical_crossentropy",
                               learning_rate=1e-2, sharding="fsdp",
                               metrics=["accuracy"], device="cpu")
    hist = est.fit((x, y), epochs=2, batch_size=16, verbose=False)
    assert np.isfinite(hist["loss"][-1]), hist
    # fsdp over the processes: the kernels' optimizer state is pieces
    assert any(est._scale.sharded), est._scale.specs
    full = [tuple(p.shape) for p in est._params]
    pieces = [tuple(p.shape) for p in est._scale.opt_params]
    assert pieces != full, (pieces, full)

    before = est.evaluate((x, y), batch_size=16)
    assert np.isfinite(before["loss"]), before
    est.save(ckpt_dir)

    # a fresh estimator: the restore reproduces the evaluation exactly
    est2 = Estimator.from_keras(model(),
                                loss="sparse_categorical_crossentropy",
                                learning_rate=1e-2, sharding="fsdp",
                                metrics=["accuracy"], device="cpu")
    est2.load(ckpt_dir)
    after = est2.evaluate((x, y), batch_size=16)
    assert abs(after["loss"] - before["loss"]) < 1e-5, (before, after)
    assert abs(after["accuracy"] - before["accuracy"]) < 1e-6
    params = est.get_model()["params"]
    flat = {f"{k}/{leaf}": v for k, d in params.items()
            for leaf, v in d.items()}
    np.savez(os.path.join(os.path.dirname(ckpt_dir),
                          f"params_p{mesh.rank}.npz"), **flat)
    print(f"MULTIHOST_OK {before['loss']:.6f} {before['accuracy']:.6f}",
          flush=True)


if __name__ == "__main__":
    main()
