"""Batch norm over a batch split across processes (``ops/fused_bn.py``'s
split form) against the JAX package's ``bn_train`` on a mesh of the same
size: the JAX op over a batch sharded on an N-device mesh takes the global
batch's moments (GSPMD inserts the all-reduce), and the port's N gloo
processes, each holding its rows, must give the same ``(y, mean, var)``
and the same VJP.  Forward and backward are compared at 1e-5 of
max(1, |ref|) in f32 (the sums run in another order) and at 2e-2 in bf16
(one bf16 ulp of an O(1) output).  The ``cuda`` cases hold the split
kernels (``csrc/fused_bn.cu``) to the plain split version and to the
one-launch kernel at a one-rank group."""


import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_serving import one_torch_thread  # noqa: F401
from analytics_zoo_tpu_torch.ops import fused_bn

pytestmark = pytest.mark.usefixtures("one_torch_thread")
EPS = 1e-3
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
SHAPES = [((8, 4, 4, 6), 2), ((6, 3, 5), 2), ((8, 2, 2, 16), 4),
          ((4, 7), 4)]


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 5).astype(np.float32)
    c = shape[-1]
    g = rng.normal(size=c).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    dm = rng.normal(size=c).astype(np.float32)
    dv = rng.normal(size=c).astype(np.float32)
    return x, g, b, dy, dm, dv


def _jax_reference(x, g, b, dy, dm, dv, n):
    """The JAX op on an n-device mesh, x sharded over its rows."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from analytics_zoo_tpu.core.context import make_mesh
    from analytics_zoo_tpu.ops.fused_bn import bn_train

    mesh = make_mesh({"data": n}, devices=jax.devices()[:n])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", *([None] * (x.ndim - 1)))))

    def f(x, g, b):
        return bn_train(x, g, b, EPS)

    out, vjp = jax.vjp(jax.jit(f), xs, jnp.asarray(g), jnp.asarray(b))
    grads = vjp((jnp.asarray(dy), jnp.asarray(dm), jnp.asarray(dv)))
    return [np.asarray(t) for t in out], [np.asarray(t) for t in grads]


def _free_port():
    # held by this process until the gang's store binds it: two gangs of
    # test files side by side never meet on one port
    from analytics_zoo_tpu_torch.core import launcher
    return launcher.reserve_port()


def _worker(rank, world, port, cases, out):
    torch.set_num_threads(1)  # a rank of a gang beside other test files
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = []
        for (x, g, b, dy, dm, dv), dtype in cases:
            n = x.shape[0] // world
            sl = slice(rank * n, (rank + 1) * n)
            xl = torch.from_numpy(x[sl]).to(dtype).requires_grad_()
            gl = torch.from_numpy(g).requires_grad_()
            bl = torch.from_numpy(b).requires_grad_()
            y, m, v = fused_bn.bn_train(xl, gl, bl, EPS,
                                        group=dist.group.WORLD)
            torch.autograd.backward(
                [y, m, v], [torch.from_numpy(dy[sl]).to(dtype),
                            torch.from_numpy(dm) / world,
                            torch.from_numpy(dv) / world])
            # dgamma, dbeta: each rank's share; the all-reduce adds them
            dg, db = gl.grad.clone(), bl.grad.clone()
            dist.all_reduce(dg)
            dist.all_reduce(db)
            res.append([t.detach().float().numpy() for t in
                        (y, m, v, xl.grad, dg, db)])
        out.put((rank, res))
    finally:
        dist.destroy_process_group()


def _run_gang(world, cases):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, cases, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = out.get(timeout=120)
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [got[r] for r in range(world)]


@pytest.fixture(scope="module")
def gangs():
    """One gloo gang a world size, every case of that size in it."""
    out = {}
    for world in (2, 4):
        cases = [(_case(shape, i), dtype)
                 for i, (shape, w) in enumerate(SHAPES) if w == world
                 for dtype in (torch.float32, torch.bfloat16)]
        out[world] = (cases, _run_gang(world, cases))
    return out


@pytest.mark.parametrize("index", range(len(SHAPES)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_batch_norm_matches_jax_on_a_mesh(gangs, index, dtype):
    shape, world = SHAPES[index]
    cases, ranks = gangs[world]
    k = next(i for i, ((x, *_), dt) in enumerate(cases)
             if x.shape == shape and str(dt) == f"torch.{dtype}")
    (x, g, b, dy, dm, dv), _ = cases[k]
    if dtype == "bfloat16":
        # the JAX op on the same bf16 values
        import ml_dtypes
        x = x.astype(ml_dtypes.bfloat16)
        dy = dy.astype(ml_dtypes.bfloat16)
    (ry, rm, rv), (rdx, rdg, rdb) = _jax_reference(x, g, b, dy, dm, dv,
                                                   world)
    y = np.concatenate([ranks[r][k][0] for r in range(world)])
    dx = np.concatenate([ranks[r][k][3] for r in range(world)])
    m, v, dg, db = ranks[0][k][1], ranks[0][k][2], ranks[0][k][4], \
        ranks[0][k][5]
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    for got, want in ((y, ry), (m, rm), (v, rv), (dx, rdx), (dg, rdg),
                      (db, rdb)):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol * scale
    # every rank holds the same global moments
    for r in range(1, world):
        np.testing.assert_array_equal(ranks[r][k][1], m)


def test_split_plain_equals_one_process_plain():
    """At one rank the plain split form is the one-launch plain version's
    arithmetic on the same sums (up to the order of the sums)."""
    port = _free_port()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        x, g, b, dy, dm, dv = (torch.from_numpy(a) for a in
                               _case((5, 3, 8), 7))
        y1, m1, v1 = fused_bn.bn_train_fwd_reference(x, g, b, EPS)
        y2, m2, v2 = fused_bn.bn_train(x, g, b, EPS, group=dist.group.WORLD)
        for a, r in ((y2, y1), (m2, m1), (v2, v1)):
            assert (a - r).abs().max() <= TOL_F32 * max(1.0, r.abs().max())
        # the split entries on the CPU count no launch
        assert all(v == 0 for v in fused_bn.split_launches().values())
    finally:
        dist.destroy_process_group()


TWO_RANK_CHECKS = {"fwd_stats", "fwd_apply", "bwd_stats", "bwd_apply",
                   "vs_one_launch"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plain_as_two_ranks_equals_one_process(dtype):
    """The split entries' plain versions run as two ranks of half the batch
    (n = 2 x rows, nonzero dmean and dvar, ``chip_smoke.split_two_ranks``)
    give the one-process plain batch norm's y, moments and dx."""
    import chip_smoke
    x, g, b, dy, dm, dv = (torch.from_numpy(a) for a in
                           _case((8, 3, 3, 16), 11))
    x, dy = x.reshape(-1, 16).to(dtype), dy.reshape(-1, 16).to(dtype)
    worst = chip_smoke.split_two_ranks(fused_bn, x, g, b, dy, dm, dv, EPS)
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    assert set(worst) == TWO_RANK_CHECKS
    assert max(worst.values()) <= tol, worst


# -- the split kernels on the card ------------------------------------------------

CUDA_SHAPES = [(1_605_632 // 16, 64), (25_088, 256), (6_272, 2048),
               (1001, 3), (333, 6), (4097, 7), (777, 1000)]


@pytest.fixture(scope="module")
def one_rank_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split kernels have no CPU "
                    "interpret mode")
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kernels_match_plain_and_one_launch(one_rank_group, rows, c,
                                                  dtype):
    gen = torch.Generator(device="cuda").manual_seed(rows + c)
    x = (torch.randn(rows, c, device="cuda", generator=gen) * 3 + 7).to(dtype)
    g = torch.randn(c, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(rows, c, device="cuda", generator=gen).to(dtype)
    outs = {}
    for kind in ("kernel", "plain", "one_launch"):
        xr = x.clone().requires_grad_()
        gr, br = g.clone().requires_grad_(), b.clone().requires_grad_()
        if kind == "one_launch":
            y, m, v = fused_bn.bn_train(xr, gr, br, EPS)
        else:
            y, m, v = fused_bn.bn_train_split(xr, gr, br, EPS, one_rank_group,
                                              plain=kind == "plain")
        y.backward(dy)
        outs[kind] = [t.float() for t in (y, m, v, xr.grad, gr.grad,
                                          br.grad)]
    tol = TOL_F32 * 4 if dtype == torch.float32 else TOL_BF16
    for ref in ("plain", "one_launch"):
        for a, r in zip(outs["kernel"], outs[ref]):
            assert (a - r).abs().max().item() <= tol * max(
                1.0, r.abs().max().item()), ref


@pytest.mark.cuda
def test_split_kernels_count_and_repeat(one_rank_group):
    x = torch.randn(4096, 64, device="cuda").to(torch.bfloat16)
    g, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    fused_bn.reset_launches()
    a = fused_bn.bn_train_split(x, g, b, EPS, one_rank_group)
    a2 = fused_bn.bn_train_split(x, g, b, EPS, one_rank_group)
    for p, q in zip(a, a2):  # no atomics: one input, one result
        assert torch.equal(p, q)
    assert fused_bn.split_launches()["split_fwd_stats"] == 2
    assert fused_bn.split_launches()["split_fwd_apply"] == 2
    assert fused_bn.SPLIT_KERNEL_LAUNCHES["split_fwd_stats_bf16"] == 2
    assert all(v == 0 for v in fused_bn.KERNEL_LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(1_605_632 // 16, 64), (25_088, 256),
                                    (6_272, 2048), (1000, 3), (4096, 7),
                                    (776, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kernels_as_two_ranks(one_rank_group, rows, c, dtype):
    """Each split kernel at n = 2 x its rows with nonzero dmean and dvar,
    as two ranks of half the batch run them, against its plain version on
    the same inputs, and the halves against the one-launch kernel over the
    whole batch (``chip_smoke.split_two_ranks``)."""
    import chip_smoke
    gen = torch.Generator(device="cuda").manual_seed(rows * c)
    x = (torch.randn(rows, c, device="cuda", generator=gen) * 3 + 7).to(dtype)
    g = torch.randn(c, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen)
    dy = torch.randn(rows, c, device="cuda", generator=gen).to(dtype)
    dm = torch.randn(c, device="cuda", generator=gen)
    dv = torch.randn(c, device="cuda", generator=gen)
    fused_bn.reset_launches()
    worst = chip_smoke.split_two_ranks(fused_bn, x, g, b, dy, dm, dv, EPS)
    tol = TOL_F32 * 4 if dtype == torch.float32 else TOL_BF16
    assert set(worst) == TWO_RANK_CHECKS
    assert max(worst.values()) <= tol, worst
    sfx = "f32" if dtype == torch.float32 else "bf16"
    assert all(fused_bn.SPLIT_KERNEL_LAUNCHES[f"{p}_{sfx}"] == 2
               for p in fused_bn.SPLIT_PASSES)
