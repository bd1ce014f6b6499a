"""Worker for the port's SIGKILL-mid-async-save chaos storm
(tests/test_torch_chaos.py), the twin of tests/ckpt_chaos_worker.py.

Trains the port's sharded-embedding NeuralCF on the CPU with ``checkpoint_async=True`` and a
trigger every 2 steps, so async generations (full + deltas) stream into
``model_dir`` while the parent test kills the process with SIGKILL at
seeded offsets.  IMMEDIATELY BEFORE each async save the worker writes a
plain synchronous mirror of the exact same train state into
``mirror_dir/step_<n>`` — the oracle the test compares the post-kill
restore against, row-exactly.  The mirror lands (synchronously, before
``save_async`` even enqueues) strictly earlier than its generation's
manifest line can, so every VISIBLE generation has a complete mirror no
matter where the kill hit.

Markers on stdout: ``TRAINING_STARTED``, then ``TRIGGERED step=<n>``
after each trigger firing (printed only once the async snapshot was
accepted).
"""

import os
import sys

import numpy as np


def main() -> None:
    model_dir = sys.argv[1]
    mirror_dir = sys.argv[2]
    epochs = int(sys.argv[3]) if len(sys.argv) > 3 else 100000
    from analytics_zoo_tpu_torch.core import checkpoint as ckpt_io
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    from analytics_zoo_tpu_torch.orca.learn.trigger import SeveralIteration

    model = NeuralCF(user_count=64, item_count=40, class_num=2,
                     user_embed=8, item_embed=8, hidden_layers=(16, 8),
                     mf_embed=8, sharded_embeddings=True)
    est = Estimator.from_keras(
        model, loss="sparse_categorical_crossentropy", optimizer="adam",
        learning_rate=1e-2, seed=7, device="cpu", model_dir=model_dir,
        checkpoint_async=True, checkpoint_inflight="block",
        checkpoint_keep_last=3)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, 64, 512),
                  rng.integers(0, 40, 512)], 1).astype(np.int32)
    y = (rng.random(512) < 0.5).astype(np.int32)

    orig_trigger = est._trigger_save

    def mirrored_trigger() -> None:
        step = est._py_step
        tree = est._save_tree()
        ckpt_io.save(os.path.join(mirror_dir, f"step_{step}"), tree,
                     step=step, extra={"epoch": int(est._epoch)})
        orig_trigger()
        print(f"TRIGGERED step={step}", flush=True)

    est._trigger_save = mirrored_trigger

    print("TRAINING_STARTED", flush=True)
    est.fit((x, y), epochs=epochs, batch_size=64,
            checkpoint_trigger=SeveralIteration(2), verbose=False)
    print(f"FINISHED step={est._py_step}", flush=True)


if __name__ == "__main__":
    main()
