"""The port's ``nn.Remat`` against the JAX package's over a block that holds
two batch norms: one training step on the CPU from the same converted
weights.  The recompute in the backward must not update the running
statistics a second time, as ``jax.checkpoint`` threads the state once.

Tolerances: the loss 1e-6 relative, running mean and var 1e-6 absolute
(values of order one; the same f32 moments in another summation order),
gradients 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.nn as jnn
from analytics_zoo_tpu.nn.layers_extra import Remat as JaxRemat
from analytics_zoo_tpu_torch import nn as tnn
from analytics_zoo_tpu_torch.convert import from_jax_variables
from analytics_zoo_tpu_torch.nn.layers import recomputing

C = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files side by side on a few cores; torch's
    default of one intra-op thread per core would crowd out the
    timing-sensitive serving tests in the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_block(momentum):
    return JaxRemat(jnn.Sequential([
        jnn.BatchNormalization(momentum=momentum), jnn.Conv2D(C, 3),
        jnn.BatchNormalization(momentum=momentum)]))


def _port_block(momentum, remat=True):
    seq = tnn.Sequential([tnn.BatchNormalization(C, momentum=momentum),
                          tnn.Conv2D(C, C, 3),
                          tnn.BatchNormalization(C, momentum=momentum)])
    return tnn.Remat(seq, "inner") if remat else seq


def _loss(y, target):
    return jnp.mean((y - target) ** 2)


@pytest.mark.parametrize("momentum", [0.99, 0.5])
def test_remat_updates_batch_norm_statistics_once_like_jax(momentum):
    rng = np.random.default_rng(0)
    x = (2.0 + rng.normal(size=(4, 6, 6, C))).astype(np.float32)
    target = rng.normal(size=(4, 6, 6, C)).astype(np.float32)
    jm = _jax_block(momentum)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # the running statistics start away from their init, so a second
    # update would show in both
    state = jax.tree_util.tree_map(
        lambda a: a + 0.25 * np.arange(a.size, dtype=np.float32
                                       ).reshape(a.shape) / a.size,
        variables["state"])
    variables = {"params": variables["params"], "state": state}

    def jloss(params):
        y, new_state = jm.apply({"params": params, "state": state},
                                jnp.asarray(x), training=True)
        return _loss(y, jnp.asarray(target)), new_state

    (want, new_state), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    port = _port_block(momentum)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port.train()
    y = port(torch.from_numpy(x))
    loss = ((y - torch.from_numpy(target)) ** 2).mean()
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(port.parameters()))))
    assert not recomputing()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    buffers = dict(port.named_buffers())
    for layer in ("00_layer0", "02_layer2"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                buffers[f"inner.{layer}.{stat}"].numpy(),
                np.asarray(new_state["inner"][layer][stat]), atol=1e-6,
                err_msg=f"{layer}/{stat}")
    for name, g in grads.items():
        _, layer, leaf = name.split(".")
        ref = np.asarray(jgrads["inner"][layer][leaf])
        if leaf == "kernel":  # HWIO -> OIHW
            ref = ref.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, err_msg=name)

    # and the statistics are those of the same block without remat
    plain = _port_block(momentum, remat=False)
    plain.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           from_jax_variables(variables).items()})
    y = plain.train()(torch.from_numpy(x))
    ((y - torch.from_numpy(target)) ** 2).mean().backward()
    for name, b in plain.named_buffers():
        torch.testing.assert_close(buffers[f"inner.{name}"], b, rtol=0,
                                   atol=1e-7)
