"""The port's fused training batch norm against the JAX package's
``ops/fused_bn.bn_train`` (its forward, and ``jax.vjp`` of the
``custom_vjp`` for the backward) on the CPU, where the wrappers take the
plain versions; ``nn.BatchNormalization`` against the JAX layer; and, on a
card, the CUDA kernels against the plain versions.

Tolerances.  float32: y within 2e-5 of max(1, max |ref|) and mean/var within
1e-6 / 1e-5 relative (the same shifted f32 sums in another order); dx
within 1e-5 and dgamma/dbeta within 2e-5 of max(1, max |ref|) (sums of up
to 150 terms of order one).  bfloat16: y and dx within one bf16 ulp of
max |ref| (2^-7): both sides round their f32 per-element results to bf16
once per operation, and a mean that differs in its last f32 bit can move
one of those roundings; the f32 statistics and dgamma/dbeta as in f32.

On the card (``cuda`` tests): the kernels run the plain version's exact
per-element operations, so y and dx are held to 1e-5 of max(1, max |ref|)
in f32 and one bf16 ulp of max |ref| in bf16 (the per-channel statistics
differ only in summation order), mean/var/dgamma/dbeta as above.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.nn import BatchNormalization as JaxBatchNorm
from analytics_zoo_tpu_torch.nn import BatchNormalization
from analytics_zoo_tpu_torch.ops import fused_bn

jbn = importlib.import_module("analytics_zoo_tpu.ops.fused_bn")
EPS = 1e-3
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, shape, centre=1e3):
    """x with a per-channel offset (channel 0's mean ``centre`` times its
    std: what the one-sample shift is for), gamma, beta, the output's
    cotangent and non-zero mean/var cotangents, all f32 numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (3.0 + 1.5 * rng.normal(size=shape)).astype(np.float32)
    x[..., 0] = centre + rng.normal(size=shape[:-1])
    return (x, rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(4, 5, 5, 6), (64, 16), (3, 7, 9, 3)]


def _f(a):
    """``a`` as a float32 numpy array of its own (writable) memory."""
    return np.array(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _close(got, want, tol, what):
    got, want = _f(got), _f(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err} > {tol} x {scale}"


def _map_tol(dtype):
    return 1e-5 if dtype == "float32" else BF16_ULP


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax(shape, dtype):
    x, g, b, *_ = _case(sum(shape), shape)
    jdt, tdt = DTYPES[dtype]
    y, m, v = jbn.bn_train(jnp.asarray(x, jdt), jnp.asarray(g),
                           jnp.asarray(b), EPS)
    ty, tm, tv = fused_bn.bn_train_fwd(torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(g),
                                       torch.from_numpy(b), EPS)
    assert ty.dtype == tdt and tm.dtype == tv.dtype == torch.float32
    assert ty.shape == shape and tm.shape == tv.shape == (shape[-1],)
    _close(ty, y, 2e-5 if dtype == "float32" else BF16_ULP, "y")
    np.testing.assert_allclose(_f(tm), _f(m), rtol=1e-6)
    np.testing.assert_allclose(_f(tv), _f(v), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, dtype):
    """dx, dgamma, dbeta with non-zero dmean/dvar cotangents."""
    x, g, b, dy, dm, dv = _case(sum(shape) + 1, shape)
    jdt, tdt = DTYPES[dtype]
    (_, m, v), vjp = jax.vjp(lambda x, g, b: jbn.bn_train(x, g, b, EPS),
                             jnp.asarray(x, jdt), jnp.asarray(g),
                             jnp.asarray(b))
    jdx, jdg, jdb = vjp((jnp.asarray(dy, jdt), jnp.asarray(dm),
                         jnp.asarray(dv)))
    tdx, tdg, tdb = fused_bn.bn_train_bwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g),
        torch.from_numpy(_f(m)), torch.from_numpy(_f(v)),
        torch.from_numpy(dy).to(tdt), torch.from_numpy(dm),
        torch.from_numpy(dv), EPS)
    assert tdx.dtype == tdt and tdg.dtype == tdb.dtype == torch.float32
    _close(tdx, jdx, _map_tol(dtype), "dx")
    _close(tdg, jdg, 2e-5, "dgamma")
    _close(tdb, jdb, 2e-5, "dbeta")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_function_matches_jax_grad(dtype):
    """``bn_train`` through ``torch.autograd.grad`` against ``jax.grad`` of
    the loss of ``tests/test_nn.py``'s fused-BN test, whose mean and var
    terms give non-zero cotangents to both."""
    x, g, b, *_ = _case(5, (4, 5, 5, 6), centre=3.0)
    jdt, tdt = DTYPES[dtype]

    def jloss(x, g, b):
        y, m, v = jbn.bn_train(x, g, b, EPS)
        return (jnp.sum(jnp.sin(y.astype(jnp.float32))) + jnp.sum(m * 1.3)
                + jnp.sum(v * 0.7))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x, jdt),
                                              jnp.asarray(g), jnp.asarray(b))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y, m, v = fused_bn.bn_train(tx, tg, tb, EPS)
    loss = torch.sin(y.float()).sum() + (m * 1.3).sum() + (v * 0.7).sum()
    got = torch.autograd.grad(loss, (tx, tg, tb))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        _close(a, w, _map_tol(dtype) if name == "dx" else 2e-5, name)


def test_plain_function_is_the_same_arithmetic():
    """``bn_train_plain`` (the card's yardstick) and ``bn_train`` give the
    same values and gradients on the CPU, where both are plain."""
    x, g, b, dy, *_ = _case(6, (2, 3, 3, 8))
    outs = []
    for fn in (fused_bn.bn_train, fused_bn.bn_train_plain):
        tx = torch.from_numpy(x).requires_grad_()
        tg = torch.from_numpy(g).requires_grad_()
        y, m, v = fn(tx, tg, torch.from_numpy(b), EPS)
        outs.append([y, m, v, *torch.autograd.grad(
            (y * torch.from_numpy(dy)).sum() + v.sum(), (tx, tg))])
    for a, w in zip(*outs):
        assert torch.equal(a, w)


def test_cpu_path_never_counts_as_a_launch():
    before = dict(fused_bn.KERNEL_LAUNCHES)
    calls = (fused_bn.bn_train_fwd.launches, fused_bn.bn_train_bwd.launches)
    x, g, b, *_ = _case(7, (8, 4))
    tx = torch.from_numpy(x).requires_grad_()
    y, _, _ = fused_bn.bn_train(tx, torch.from_numpy(g), torch.from_numpy(b),
                                EPS)
    y.sum().backward()
    assert dict(fused_bn.KERNEL_LAUNCHES) == before
    assert (fused_bn.bn_train_fwd.launches,
            fused_bn.bn_train_bwd.launches) == calls
    assert set(before) == {f"{p}_{s}" for p in fused_bn.PASSES
                           for s in ("f32", "bf16")}


def test_wrapper_raises_on_other_devices_and_bad_shapes():
    meta = torch.empty(4, 3, device="meta")
    c = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_bn.bn_train_fwd(meta, c, c, EPS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_bn.bn_train_bwd(meta, c, c, c, meta, c, c, EPS)
    with pytest.raises(ValueError, match=r"\[3\]"):
        fused_bn.bn_train_fwd(torch.zeros(4, 3), torch.zeros(4),
                              torch.zeros(3), EPS)
    with pytest.raises(ValueError, match="empty"):
        fused_bn.bn_train_fwd(torch.zeros(0, 3), torch.zeros(3),
                              torch.zeros(3), EPS)
    with pytest.raises(ValueError, match="does not match"):
        fused_bn.bn_train_bwd(torch.zeros(4, 3), *[torch.zeros(3)] * 3,
                              torch.zeros(5, 3), torch.zeros(3),
                              torch.zeros(3), EPS)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_bn._check_launch(torch.zeros(4, 3, dtype=torch.float16))


@pytest.mark.parametrize("rows,c,itemsize,vec", [
    (1_605_632, 64, 2, True), (6_272, 2048, 2, True), (392, 1000, 4, True),
    (8, 3, 4, False), (1, 7, 2, False), (100_000, 6, 2, False)])
def test_grid_fills_the_card_within_its_limits(rows, c, itemsize, vec):
    """ResNet-50's stem and last-stage maps, the edge widths: one block an
    SM at most (the cooperative launch's limit), every SM a block where
    there are rows enough, at least 4 rows a thread otherwise, never more
    than 512 threads a block, the rows kept on chip within the block's
    shared memory, and a workspace of [2 C] outputs, the [splits, 2, C]
    partials, [4 C] per-channel scalars and the barrier's word, in both
    directions."""
    for direction in ("fwd", "bwd"):
        p = fused_bn.plan(rows, c, itemsize, vec, direction, 132)
        nvec = c // (16 // itemsize) if vec else c
        assert 1 <= p.tx <= 512 and p.tx * p.ty <= 512
        assert p.ctiles == -(-nvec // p.tx)
        assert 1 <= p.blocks <= 132
        units = max(p.blocks, p.ctiles)
        assert p.splits == -(-units // p.ctiles)
        assert p.rows_per_block == -(-rows // (units // p.ctiles))
        if rows >= 1_000_000 or c >= 2048:
            assert p.blocks == 132  # every SM has a block
        else:
            assert p.blocks == 1 or p.rows_per_block >= p.ty * 4 * 0.5
        maps = 1 if direction == "fwd" else 2
        assert p.smem_bytes == p.keep * p.tx * (16 if vec else itemsize) \
            * maps
        assert p.smem_bytes <= fused_bn.RESIDENT_BYTES
        assert p.keep <= p.rows_per_block
        assert (p.keep > 0) == vec  # the scalar path streams every row
        assert p.work_floats == 6 * c + 2 * p.splits * c + 1


# ResNet-50's 12 distinct batch-norm maps at batch 128 (224 x 224 images,
# the space-to-depth stem) with how many of its 53 norms see each: the
# shapes chip_smoke.py times and dev/torch_bn_parts.py sums over
RESNET50_MAPS = {
    (1_605_632, 64): 1, (401_408, 64): 6, (401_408, 256): 4,
    (401_408, 128): 1, (100_352, 128): 7, (100_352, 512): 5,
    (100_352, 256): 1, (25_088, 256): 11, (25_088, 1024): 7,
    (25_088, 512): 1, (6_272, 512): 5, (6_272, 2048): 4}


def test_resnet50_maps_are_the_models_own():
    """The table above is what the port's ResNet-50 gives its batch norms
    (chip_smoke.resnet_bn_maps, on the CPU at one image)."""
    import chip_smoke
    assert chip_smoke.resnet_bn_maps(128, device="cpu") == RESNET50_MAPS
    assert sum(RESNET50_MAPS.values()) == chip_smoke.RESNET_BN


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("rows,c", list(RESNET50_MAPS))
def test_plan_keeps_the_resnet50_maps_on_chip(rows, c, direction):
    """bf16 on 132 SMs: a map of at most 25.7 MB is read from device memory
    once in the forward (every block keeps all its rows), one of at most
    12.85 MB in the backward (dy and x both kept); of a larger map (the
    205 MB stem's among them) each block keeps a part and streams the
    rest; always within the 227 KB a block may have."""
    p = fused_bn.plan(rows, c, 2, True, direction, 132)
    mb = rows * c * 2 / 1e6
    whole = mb <= (25.7 if direction == "fwd" else 12.85)
    assert p.blocks == 132
    assert (p.keep == p.rows_per_block) == whole
    assert 0 < p.keep <= p.rows_per_block
    static = 512 * 8 * 4 + 64  # the reduction buffer and the mbarriers
    assert p.ctiles == 1  # whole rows: one bulk copy a piece
    assert p.smem_bytes + static <= fused_bn.SMEM_PER_BLOCK
    if not whole:  # as many rows as fit in the budget
        maps = 1 if direction == "fwd" else 2
        assert p.smem_bytes + p.tx * 16 * maps > fused_bn.RESIDENT_BYTES


def _jax_layer(x, variables, training, axis=-1):
    layer = JaxBatchNorm(axis=axis)
    return layer.apply(variables, jnp.asarray(x), training=training)


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_layer_matches_jax(training, axis):
    """Channel-last training takes ``bn_train``; training over another
    axis the inline shifted moments; eval the running statistics.  Output,
    the updated running statistics and the parameter gradients."""
    rng = np.random.default_rng(3)
    x = (2.0 + rng.normal(size=(4, 6, 5, 5))).astype(np.float32)
    c = x.shape[axis]
    variables = {
        "params": {"gamma": rng.normal(size=(c,)).astype(np.float32),
                   "beta": rng.normal(size=(c,)).astype(np.float32)},
        "state": {"mean": rng.normal(size=(c,)).astype(np.float32),
                  "var": rng.uniform(0.5, 1.5, (c,)).astype(np.float32)}}
    want, new_state = _jax_layer(x, variables, training, axis)
    jgrads = jax.grad(lambda p: jnp.sum(jnp.sin(_jax_layer(
        x, {**variables, "params": p}, training, axis)[0])))(
            variables["params"])

    layer = BatchNormalization(c, axis=axis).train(training)
    layer.load_state_dict({**{k: torch.from_numpy(v) for k, v in
                              variables["params"].items()},
                           **{k: torch.from_numpy(v) for k, v in
                              variables["state"].items()}})
    got = layer(torch.from_numpy(x))
    grads = torch.autograd.grad(torch.sin(got).sum(),
                                (layer.gamma, layer.beta))
    _close(got, want, 2e-5, "y")
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(layer, name).numpy(),
                                   np.asarray(new_state[name]), rtol=1e-6,
                                   atol=1e-7)
    for name, a in zip(("gamma", "beta"), grads):
        _close(a, jgrads[name], 2e-5, name)


def test_batchnorm_training_updates_buffers_with_keras_momentum():
    """``0.99 * run + 0.01 * batch`` with the biased batch variance: not
    ``torch.nn.BatchNorm2d``'s rule."""
    x = torch.from_numpy(_case(9, (16, 4), centre=3.0)[0])
    layer = BatchNormalization(4).train()
    layer(x)
    np.testing.assert_allclose(layer.mean.numpy(),
                               0.01 * x.mean(0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(layer.var.numpy(),
                               0.99 + 0.01 * x.var(0, unbiased=False).numpy(),
                               rtol=1e-6)


# -- the kernels, on a card ---------------------------------------------------

# every distinct (rows, C) of ResNet-50's 53 batch norms at batch 2 (224 x
# 224: the card-test batch; chip_smoke.py runs batch 128), the edge widths,
# rows that fill no block evenly, channels in more tiles than the card has
# SMs (each block takes several, streaming every row)
CARD_SHAPES = [(2 * 112 * 112, 64), (2 * 56 * 56, 64), (2 * 56 * 56, 256),
               (2 * 28 * 28, 128), (2 * 28 * 28, 512), (2 * 14 * 14, 256),
               (2 * 14 * 14, 1024), (2 * 7 * 7, 512), (2 * 7 * 7, 2048),
               (5, 3), (1001, 6), (333, 7), (77, 1000), (1, 8), (257, 1000),
               (40, 4500), (9, 40_000)]  # more channel tiles than SMs


def _card_inputs(seed, rows, c, dtype, offset=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = 2.0 + r(rows, c)
    x[:, 0] = 1e3 + x[:, 0] - 2.0  # a channel whose mean is 1e3 x its std
    if offset:  # a view at an odd element offset: the scalar path
        buf = torch.empty(rows * c + offset, device="cuda", dtype=dtype)
        buf[offset:] = x.reshape(-1).to(dtype)
        x = buf[offset:].view(rows, c)
    else:
        x = x.to(dtype)
    dy = r(rows, c).to(dtype)
    return x, 1.0 + 0.1 * r(c), 0.1 * r(c), dy, r(c), r(c)


def _card_check(x, g, b, dy, dm, dv):
    dt = "float32" if x.dtype == torch.float32 else "bfloat16"
    y, m, v = fused_bn.bn_train_fwd(x, g, b, EPS)
    ry, rm, rv = fused_bn.bn_train_fwd_reference(x, g, b, EPS)
    dx, dg, db = fused_bn.bn_train_bwd(x, g, m, v, dy, dm, dv, EPS)
    rdx, rdg, rdb = fused_bn.bn_train_bwd_reference(x, g, m, v, dy, dm, dv,
                                                    EPS)
    torch.cuda.synchronize()
    _close(y.cpu(), ry.cpu(), _map_tol(dt), "y")
    _close(m.cpu(), rm.cpu(), 1e-6, "mean")
    _close(v.cpu(), rv.cpu(), 1e-5, "var")
    _close(dx.cpu(), rdx.cpu(), _map_tol(dt), "dx")
    _close(dg.cpu(), rdg.cpu(), 2e-5, "dgamma")
    _close(db.cpu(), rdb.cpu(), 2e-5, "dbeta")
    return y, m, v, dx, dg, db


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", CARD_SHAPES)
def test_kernels_match_plain_on_card(rows, c, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sfx = "f32" if dtype == torch.float32 else "bf16"
    before = dict(fused_bn.KERNEL_LAUNCHES)
    _card_check(*_card_inputs(rows + c, rows, c, dtype))
    after = dict(fused_bn.KERNEL_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        f"{p}_{s}": int(s == sfx) for p in fused_bn.PASSES
        for s in ("f32", "bf16")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_a_misaligned_view_and_repeat_bits(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    inputs = _card_inputs(11, 3001, 64, dtype, offset=1)
    assert inputs[0].data_ptr() % 16 != 0
    first = _card_check(*inputs)
    again = _card_check(*inputs)  # no atomics: identical bits
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,whole", [(401_408, 64, False),
                                          (6_272, 512, True)])
def test_kernels_keep_or_stream_the_map_and_repeat_bits(rows, c, whole,
                                                        dtype):
    """A map larger than the blocks' shared memory together (51 MB in bf16,
    ResNet-50's stage 1 at batch 32: part kept, the rest re-read) and one
    smaller (every row kept in both directions), against the plain
    versions, twice with identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sms = fused_bn._sm_count(torch.cuda.current_device())
    for direction in ("fwd", "bwd"):
        p = fused_bn.plan(rows, c, dtype.itemsize, True, direction, sms)
        assert (p.keep == p.rows_per_block) == whole and p.keep > 0
    inputs = _card_inputs(rows ^ c, rows, c, dtype)
    first = _card_check(*inputs)
    again = _card_check(*inputs)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_replay_in_a_cuda_graph(dtype):
    """Both directions captured in one ``torch.cuda.CUDAGraph`` (the
    cooperative launches and the barrier word's reset on the stream) and
    replayed three times give the eager call's bits each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, g, b, dy, dm, dv = _card_inputs(21, 25_088, 256, dtype)

    def both():
        y, m, v = fused_bn.bn_train_fwd(x, g, b, EPS)
        return (y, m, v, *fused_bn.bn_train_bwd(x, g, m, v, dy, dm, dv, EPS))

    eager = [t.clone() for t in both()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    for _ in range(3):
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, want in zip(captured, eager):
            assert torch.equal(a, want)
