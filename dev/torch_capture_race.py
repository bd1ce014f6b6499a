"""Why did a captured train step fail now and then?  First suspect:
``fit(prefetch=2)``'s producer thread placing the next batch
(``torch.from_numpy(a).to("cuda")``: an allocation and a pageable copy on
the legacy default stream) while the main thread captures the train step
in ``capture_error_mode="thread_local"``.  The cause proved to be the
garbage collector instead: ``torch.cuda.graph`` no longer collects before
it captures, and a dead graph collected during a capture breaks it
(ROADMAP Queue 3, closed; ``analytics_zoo_tpu_torch.collector_held``).

Three modes, each capturing a small step (matmul, exp, sum; run once on
the capture stream first) ``--captures`` times, every capture in a fresh
``torch.cuda.graph`` (which synchronises and empties the allocator's cache
before it begins): ``quiet`` (no other thread), ``producer`` (a thread
placing int32 batches of the KNRM test's shape in a loop), ``paused``
(the same thread, but holding a lock around each placement that the
capture holds too).  Prints one JSON line a mode: captures, failures and
the first error.  ``--fits N`` instead runs the captured KNRM fit of
``tests/test_torch_readers_cuda.py::test_clipping_losses_capture_as_eager``
(hinge loss, 2 epochs of 4 batches) N times with ``prefetch=2``, then N
times with ``prefetch=0`` (no producer thread), in turns, and counts the
fits whose capture failed.  ``--clip N`` runs the test's three cases
(binary_crossentropy, hinge, huber: an eager fit, then a captured fit at
the default prefetch, whose step losses must equal the eager ones) N
times each, the losses in turns, and counts the cases that failed; with
``PYTHONPATH`` set to another tree's root it runs that tree's package.

    python3 dev/torch_capture_race.py [--captures 200] [--fits 0] [--clip 0]
"""

import argparse
import json
import os
import threading
import time

import numpy as np
import torch


def producer(stop, lock, placed):
    a = np.ones((32, 50), np.int32)
    while not stop.is_set():
        if lock is not None:
            with lock:
                x = torch.from_numpy(a).to("cuda")
        else:
            x = torch.from_numpy(a).to("cuda")
        placed[0] += 1
        del x


def run(mode, captures):
    w = torch.randn(256, 256, device="cuda")
    x = torch.randn(64, 256, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # cuBLAS's handle and workspace first
        torch.exp(torch.tanh(x @ w)).sum()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    stop, placed = threading.Event(), [0]
    lock = threading.Lock() if mode == "paused" else None
    thread = None
    if mode != "quiet":
        thread = threading.Thread(target=producer, args=(stop, lock, placed),
                                  daemon=True)
        thread.start()
    failures, first = 0, None
    try:
        for _ in range(captures):
            g = torch.cuda.CUDAGraph()
            held = lock.acquire() if lock is not None else False
            try:
                with torch.cuda.graph(g, stream=stream,
                                      capture_error_mode="thread_local"):
                    y = torch.exp(torch.tanh(x @ w)).sum()
                g.replay()
                float(y)
            except Exception as e:  # noqa: BLE001 — counted, reported
                failures += 1
                first = first or f"{type(e).__name__}: {str(e)[:200]}"
                torch.cuda.synchronize()
            finally:
                if held:
                    lock.release()
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=10)
    return {"mode": mode, "captures": captures, "failures": failures,
            "placements": placed[0], "first_error": first,
            "device": torch.cuda.get_device_name(0)}


def knrm_fits(fits):
    """The clipping test's captured KNRM fit ``fits`` times a prefetch
    depth, the depths in turns: {depth: (fits, failures, first error)}."""
    from analytics_zoo_tpu_torch.models import KNRM
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    rng = np.random.default_rng(3)
    x = rng.integers(0, 200, (128, 50)).astype(np.int32)
    y = (rng.random((128, 1)) < 0.5).astype(np.float32)
    torch.manual_seed(0)
    init = KNRM(10, 40, vocab_size=200, embed_size=32).state_dict()
    out = {2: [0, 0, None], 0: [0, 0, None]}
    for _ in range(fits):
        for depth in (2, 0):
            model = KNRM(10, 40, vocab_size=200, embed_size=32)
            model.load_state_dict(init)
            est = Estimator.from_keras(model, loss="hinge", optimizer="adam",
                                       learning_rate=1e-2)
            out[depth][0] += 1
            try:
                est.fit((x, y), epochs=2, batch_size=32, verbose=False,
                        prefetch=depth)
            except RuntimeError as e:
                out[depth][1] += 1
                out[depth][2] = out[depth][2] or str(e)[:200]
                torch.cuda.synchronize()
    return out


CLIP_LOSSES = ("binary_crossentropy", "hinge", "huber")


def clipping_cases(n):
    """``test_clipping_losses_capture_as_eager``'s three cases ``n`` times
    each: {loss: [runs, failures, first error]}."""
    import analytics_zoo_tpu_torch
    from analytics_zoo_tpu_torch.models import KNRM
    from analytics_zoo_tpu_torch.orca.learn import Estimator
    rng = np.random.default_rng(3)
    x = rng.integers(0, 200, (128, 50)).astype(np.int32)
    y = (rng.random((128, 1)) < 0.5).astype(np.float32)
    torch.manual_seed(0)
    init = KNRM(10, 40, vocab_size=200, embed_size=32).state_dict()
    out = {loss: [0, 0, None] for loss in CLIP_LOSSES}
    for _ in range(n):
        for loss in CLIP_LOSSES:
            out[loss][0] += 1
            try:
                got = {}
                for graphs in (False, True):
                    model = KNRM(10, 40, vocab_size=200, embed_size=32)
                    model.load_state_dict(init)
                    est = Estimator.from_keras(
                        model, loss=loss, optimizer="adam",
                        learning_rate=1e-2, cuda_graphs=graphs)
                    seen, inner = [], est._train_step
                    est._train_step = (lambda b, seen=seen, inner=inner:
                                       seen.append(inner(b)) or seen[-1])
                    est.fit((x, y), epochs=2, batch_size=32, verbose=False)
                    got[graphs] = [float(v) for v in seen]
                    if graphs and est.capture_count != 1:
                        raise RuntimeError(
                            f"{est.capture_count} captures, not 1")
                if got[True] != got[False]:
                    raise RuntimeError("captured losses differ from eager")
            except RuntimeError as e:
                out[loss][1] += 1
                out[loss][2] = out[loss][2] or str(e)[:200]
                torch.cuda.synchronize()
    return out, os.path.dirname(os.path.dirname(
        os.path.abspath(analytics_zoo_tpu_torch.__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", type=int, default=200)
    ap.add_argument("--fits", type=int, default=0)
    ap.add_argument("--clip", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.clip:
        t0 = time.monotonic()
        out, tree = clipping_cases(args.clip)
        for loss, (n, bad, first) in out.items():
            print(json.dumps({"loss": loss, "cases": n, "failures": bad,
                              "first_error": first, "tree": tree,
                              "seconds": time.monotonic() - t0,
                              "device": torch.cuda.get_device_name(0)}),
                  flush=True)
        return
    if args.fits:
        for depth, (n, bad, first) in knrm_fits(args.fits).items():
            print(json.dumps({"prefetch": depth, "fits": n, "failures": bad,
                              "first_error": first,
                              "device": torch.cuda.get_device_name(0)}),
                  flush=True)
        return
    for mode in ("quiet", "producer", "paused", "producer", "quiet"):
        print(json.dumps(run(mode, args.captures)), flush=True)


if __name__ == "__main__":
    main()
