"""``chip_smoke.py``'s parallel_extras phase end to end through its CPU
seam: the 2-rank gloo gang (ring attention, MoE, the pipeline and the
row-sharded tables, each under its own mesh) and this process's
references, at tiny widths, with the kernels' plain versions."""

import importlib
import os
import sys

import pytest

from _torch_serving import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_chip_smoke_parallel_extras_phase_runs_on_the_cpu_at_tiny_sizes():
    """Each case within its tolerance of its one-process reference, the
    experts and the tables' rows halved over the ranks, no whole table
    allocated, the pipeline's output equal to the stages in order, no
    kernel launched and nothing staged through the host (CPU tensors)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    ops = [importlib.import_module(f"analytics_zoo_tpu_torch.ops.{m}")
           for m in ("flash_attention", "fused_bn", "fused_xent")]
    sizes = chip_smoke.ExtrasSizes(
        device="cpu", bert=dict(vocab_size=50, hidden_size=32, n_layers=2,
                                n_heads=4, intermediate_mult=4,
                                max_position=16, dropout=0.0),
        seq=16, bert_batch=4, bert_steps=2, moe_d=16, moe_t=8, moe_batch=4,
        moe_experts=4, moe_mult=2, moe_steps=2, pipe_stages=4, pipe_batch=4,
        pipe_micro=2, ncf_users=64, ncf_items=40, ncf_batch=32, ncf_steps=2)
    res = chip_smoke.phase_parallel_extras(*ops, sizes)
    assert max(res["ring"]["worst_rel_gap"]) <= chip_smoke.TOL_SCALEOUT_GANG
    for r in res["ring"]["ranks"]:
        for errs in r["check"].values():
            assert max(errs.values()) == 0.0  # both rings plain here
    assert res["moe"]["worst_rel_gap"] == [0.0, 0.0]
    for r in res["moe"]["ranks"]:
        assert r["expert_weights"]["moe_0.wi"]["shape"] == [2, 16, 32]
    assert all(r["equal_bits"] for r in res["pipe"]["ranks"])
    assert [r["stages_here"] for r in res["pipe"]["ranks"]] == [[0, 2],
                                                                [2, 4]]
    assert res["tables"]["worst_row_rel_err"] <= chip_smoke.TOL_EXTRAS_TABLES
    for r in res["tables"]["ranks"]:
        assert 2 * r["table_bytes_held"] == r["table_bytes_whole"]
    assert not any(res["kernel_launches"].values())
    assert all(s == {"copies": 0, "bytes": 0}
               for case in res["staged"].values() for s in case)
