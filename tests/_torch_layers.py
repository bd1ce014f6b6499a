"""The layer parity harness of ``tests/test_torch_layers_extra.py`` and
``tests/test_torch_layers_zoo.py``: a JAX layer and the port's, one seeded
input, outputs and gradients held at a stated tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from analytics_zoo_tpu_torch.convert import from_jax_variables, \
    to_jax_variables


def held(jlayer, player, shapes, domain=(-2.0, 2.0), tol=1e-5, seed=0):
    """Forward and gradient parity of one layer (see the module
    docstring); returns the port's output."""
    rng = np.random.default_rng(seed)
    multi = isinstance(shapes, list)
    xs = [rng.uniform(*domain, s).astype(np.float32)
          for s in (shapes if multi else [shapes])]
    jarg = [jnp.asarray(x) for x in xs] if multi else jnp.asarray(xs[0])
    variables = jlayer.init(jax.random.PRNGKey(0), jarg)
    player.load_state_dict(from_jax_variables(variables), strict=True)
    player.eval()
    jout, _ = jlayer.apply(variables, jarg)
    jout = np.asarray(jout)
    targ = [torch.tensor(x, requires_grad=True) for x in xs]
    pout = player(targ if multi else targ[0])
    assert tuple(pout.shape) == jout.shape
    scale = max(1.0, float(np.abs(jout).max()))
    np.testing.assert_allclose(pout.detach().numpy(), jout, rtol=tol,
                               atol=tol * scale)
    cot = rng.normal(size=jout.shape).astype(np.float32)

    def jf(params, xin):
        out, _ = jlayer.apply({"params": params,
                               "state": variables.get("state", {})}, xin)
        return jnp.sum(out * cot)

    gp, gx = jax.grad(jf, argnums=(0, 1))(variables["params"], jarg)
    names = [n for n, _ in player.named_parameters()]
    params = [p for _, p in player.named_parameters()]
    grads = torch.autograd.grad((pout * torch.as_tensor(cot)).sum(),
                                params + targ, allow_unused=True)
    want_p = jax.tree_util.tree_leaves(gp)
    got_p = jax.tree_util.tree_leaves(to_jax_variables(
        {n: g if g is not None else torch.zeros_like(p)
         for n, g, p in zip(names, grads, params)})["params"])
    assert len(want_p) == len(got_p)
    for want, got in zip(want_p + list(jax.tree_util.tree_leaves(gx)),
                         got_p + [g.numpy() for g in grads[len(params):]]):
        want = np.asarray(want)
        g_scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * g_scale)
    return pout
