"""Worker for the port's SIGTERM test (tests/test_torch_failover.py), after
tests/preemption_worker.py: trains "forever" on the CPU until SIGTERM,
then exits 143 after the preemption checkpoint (``core/failover.py``); on
a second run with a checkpoint present, auto-resumes and prints the
resumed and the final step.

Usage: ``python tests/_torch_preemption_worker.py MODEL_DIR [EPOCHS]
[async]``."""

import sys

import numpy as np


def main() -> None:
    model_dir = sys.argv[1]
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 100000
    use_async = len(sys.argv) > 3 and sys.argv[3] == "async"
    import torch

    from analytics_zoo_tpu_torch import nn as tnn
    from analytics_zoo_tpu_torch.core.failover import Preempted
    from analytics_zoo_tpu_torch.orca.learn import Estimator

    torch.set_num_threads(1)
    model = tnn.Sequential([tnn.Dense(4, 8, activation="relu"),
                            tnn.Dense(8, 1)])
    est = Estimator.from_keras(model, loss="mse", learning_rate=1e-3,
                               model_dir=model_dir, device="cpu",
                               preemption_checkpoint=True,
                               preemption_sync_every=2,
                               checkpoint_async=use_async)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    y = rng.normal(size=(256, 1)).astype(np.float32)
    print("TRAINING_STARTED", flush=True)
    try:
        est.fit((x, y), epochs=epochs, batch_size=32, auto_resume=True,
                verbose=False)
    except Preempted as e:
        print(f"PREEMPTED step={e.step} durable={e.durable} path={e.path}",
              flush=True)
        sys.exit(143)
    print(f"FINISHED step={est._py_step}", flush=True)


if __name__ == "__main__":
    main()
