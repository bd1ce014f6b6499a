"""Foreign-model import in the port (``models/net.py``) against the JAX
package's converter and the source framework: the twins of
``tests/test_net.py``.

Every converted net is held three ways on the same seeded inputs: its
output against the torch (or Keras) model's own, at the JAX test's
tolerance; against the JAX converter's output, at the same tolerance; and
its weights against the JAX converter's tree (the JAX variables load into
the port's net with ``load_state_dict(strict=True)``, and its
``state_dict`` goes back to the same tree).  Fine-tuning fits are held to
the JAX ``Estimator`` on the same converted weights at 1e-5 of the loss.
The Keras cases ``importorskip("tensorflow")``; they all live in this file,
so a worker imports TensorFlow once.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import init_orca_context
from analytics_zoo_tpu.models import Net as JaxNet
from analytics_zoo_tpu.orca.learn import Estimator as JaxEstimator
from analytics_zoo_tpu_torch.convert import (buffer_names,
                                             from_jax_variables,
                                             to_jax_variables)
from analytics_zoo_tpu_torch.models import (ForeignGraphNet, ForeignNet,
                                            Net)
from analytics_zoo_tpu_torch.orca.learn import Estimator

TNN = torch.nn


@pytest.fixture(autouse=True)
def _ctx():
    init_orca_context("local")
    yield


def _port(net, *xs) -> np.ndarray:
    net.eval()
    with torch.no_grad():
        return net(*(torch.as_tensor(x) for x in xs)).numpy()


def _jax(net, *xs):
    variables = net.init(jax.random.PRNGKey(0), *xs)
    out, _ = net.apply(variables, *xs)
    return np.asarray(out), variables


def _same_tree(port_net, jax_vars) -> None:
    """The JAX converter's tree loads into the port's net strictly, and
    the port's ``state_dict`` goes back to it leaf for leaf."""
    port_net.load_state_dict(from_jax_variables(jax_vars), strict=True)
    back = to_jax_variables(port_net.state_dict(), buffer_names(port_net))
    flat_j = jax.tree_util.tree_flatten_with_path(
        {"params": jax_vars["params"], "state": jax_vars["state"]})[0]
    flat_p = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_j] == \
        [jax.tree_util.keystr(k) for k, _ in flat_p]
    for (_, a), (_, b) in zip(flat_j, flat_p):
        np.testing.assert_array_equal(np.asarray(a), b)


def _held(tm, x, atol, graph=False, kind=ForeignNet):
    """Convert ``tm`` in both packages; hold the port's output to torch's
    and to the JAX converter's at ``atol``, and the trees equal."""
    load = "load_torch_graph" if graph else "load_torch"
    with torch.no_grad():
        want = tm.eval()(torch.as_tensor(x)).numpy()
    net = getattr(Net, load)(tm, x)
    assert isinstance(net, kind)
    got = _port(net, x)
    jout, jvars = _jax(getattr(JaxNet, load)(tm, x), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, jout, atol=atol)
    _same_tree(net, jvars)
    return net, got


# -- torch, chains ---------------------------------------------------------

def test_load_torch_mlp_differential():
    tm = TNN.Sequential(TNN.Linear(8, 16), TNN.ReLU(), TNN.LayerNorm(16),
                        TNN.Linear(16, 4), TNN.Tanh())
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    net, _ = _held(tm, x, 1e-5)
    assert list(net.state_dict())[:2] == ["0_linear.kernel", "0_linear.bias"]


def test_load_torch_convnet_differential():
    """Conv, BN, pool, flatten, linear: NCHW in, the Flatten/Linear rows
    reordered into NHWC order."""
    tm = TNN.Sequential(TNN.Conv2d(3, 6, 3, padding=1), TNN.ReLU(),
                        TNN.BatchNorm2d(6), TNN.MaxPool2d(2),
                        TNN.Conv2d(6, 4, 3), TNN.Flatten(),
                        TNN.Linear(4 * 5 * 5, 10)).eval()
    with torch.no_grad():
        tm[2].running_mean.uniform_(-0.5, 0.5)
        tm[2].running_var.uniform_(0.5, 1.5)
    x = np.random.default_rng(1).normal(size=(4, 3, 14, 14)) \
        .astype(np.float32)
    net, _ = _held(tm, x, 1e-4)
    assert net.nchw_input


def test_load_torch_torchscript_file(tmp_path):
    tm = TNN.Sequential(TNN.Linear(4, 3), TNN.Sigmoid())
    path = str(tmp_path / "m.pt")
    torch.jit.script(tm).save(path)
    x = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    net = Net.load_torch(path, x)
    jout, _ = _jax(JaxNet.load_torch(path, x), x)
    with torch.no_grad():
        want = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(_port(net, x), want, atol=1e-5)
    np.testing.assert_allclose(_port(net, x), jout, atol=1e-5)


def test_load_torch_unsupported_layer_names_escape_hatch():
    tm = TNN.Sequential(TNN.Linear(4, 4), TNN.MultiheadAttention(4, 2))
    with pytest.raises(NotImplementedError, match="escape hatch"):
        Net.load_torch(tm, np.zeros((2, 4), np.float32))


def test_torch_params_to_tree():
    tm = TNN.Sequential(TNN.Linear(3, 2), TNN.BatchNorm1d(2))
    tree = Net.torch_params_to_tree(tm)
    assert tree.keys() == JaxNet.torch_params_to_tree(tm).keys()
    assert tree["0.weight"].shape == (2, 3)
    assert "1.running_mean" in tree


def test_load_torch_finetunes_through_estimator():
    """Imported weights, fine-tuned: the port's fit held to the JAX
    Estimator's on the same converted net."""
    tm = TNN.Sequential(TNN.Linear(6, 8), TNN.ReLU(), TNN.Linear(8, 2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    net = Net.load_torch(tm, x[:2])
    with torch.no_grad():
        np.testing.assert_allclose(_port(net, x[:4]),
                                   tm(torch.as_tensor(x[:4])).numpy(),
                                   atol=1e-5)
    est = Estimator.from_keras(net, loss="sparse_categorical_crossentropy",
                               learning_rate=1e-2, device="cpu")
    jest = JaxEstimator.from_keras(JaxNet.load_torch(tm, x[:2]),
                                   loss="sparse_categorical_crossentropy",
                                   learning_rate=1e-2)
    hist = est.fit((x, y), epochs=3, batch_size=16, verbose=False)
    jhist = jest.fit((x, y), epochs=3, batch_size=16, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)


def test_load_torch_head_with_dropout_between_flatten_and_linear():
    tm = TNN.Sequential(TNN.Conv2d(2, 3, 3), TNN.Flatten(), TNN.Dropout(0.5),
                        TNN.ReLU(), TNN.Linear(3 * 4 * 4, 5)).eval()
    x = np.random.default_rng(4).normal(size=(2, 2, 6, 6)).astype(np.float32)
    _held(tm, x, 1e-5)


def test_load_torch_conv_ending_net_keeps_torch_layout():
    tm = TNN.Sequential(TNN.Conv2d(3, 5, 3), TNN.ReLU())
    x = np.random.default_rng(5).normal(size=(2, 3, 8, 8)).astype(np.float32)
    _, out = _held(tm, x, 1e-5)
    assert out.shape == (2, 5, 6, 6)


def test_load_torch_exact_gelu():
    """torch's GELU is the erf form, not the port's tanh "gelu"."""
    tm = TNN.Sequential(TNN.Linear(16, 16), TNN.GELU())
    x = np.random.default_rng(6).normal(size=(8, 16)).astype(np.float32)
    _held(tm, x, 1e-6)
    tm2 = TNN.Sequential(TNN.Linear(16, 16), TNN.GELU(approximate="tanh"))
    _held(tm2, x, 1e-6)


def test_load_bigdl_documented_drop():
    with pytest.raises(NotImplementedError, match="consciously dropped"):
        Net.load_bigdl("whatever")
    with pytest.raises(NotImplementedError, match="consciously dropped"):
        Net.load_caffe("whatever")


# -- torch, graphs -----------------------------------------------------------

def _resnet18_torch(w=8, classes=10):
    """torchvision-style ResNet-18 (``tests/test_net.py``'s)."""

    class BasicBlock(TNN.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = TNN.Conv2d(cin, cout, 3, stride=stride, padding=1,
                                    bias=False)
            self.bn1 = TNN.BatchNorm2d(cout)
            self.relu = TNN.ReLU(inplace=True)
            self.conv2 = TNN.Conv2d(cout, cout, 3, padding=1, bias=False)
            self.bn2 = TNN.BatchNorm2d(cout)
            self.downsample = (
                TNN.Sequential(TNN.Conv2d(cin, cout, 1, stride=stride,
                                          bias=False), TNN.BatchNorm2d(cout))
                if (stride != 1 or cin != cout) else None)

        def forward(self, x):
            identity = x if self.downsample is None else self.downsample(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            out += identity
            return self.relu(out)

    def layer(cin, cout, stride):
        return TNN.Sequential(BasicBlock(cin, cout, stride),
                              BasicBlock(cout, cout))

    class ResNet18(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = TNN.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
            self.bn1 = TNN.BatchNorm2d(w)
            self.relu = TNN.ReLU(inplace=True)
            self.maxpool = TNN.MaxPool2d(3, stride=2, padding=1)
            self.layer1 = layer(w, w, 1)
            self.layer2 = layer(w, 2 * w, 2)
            self.layer3 = layer(2 * w, 4 * w, 2)
            self.layer4 = layer(4 * w, 8 * w, 2)
            self.avgpool = TNN.AdaptiveAvgPool2d(1)
            self.fc = TNN.Linear(8 * w, classes)

        def forward(self, x):
            x = self.relu(self.bn1(self.conv1(x)))
            x = self.maxpool(x)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            return self.fc(torch.flatten(self.avgpool(x), 1))

    m = ResNet18().eval()
    g = torch.Generator().manual_seed(7)
    for mod in m.modules():
        if isinstance(mod, TNN.BatchNorm2d):
            mod.running_mean.uniform_(-0.5, 0.5, generator=g)
            mod.running_var.uniform_(0.5, 2.0, generator=g)
    return m


def test_load_torch_resnet18_graph_differential():
    """The ResNet-18-style graph at width 8 and 64x64 through torch.fx:
    torch's output, the JAX converter's and its tree."""
    m = _resnet18_torch()
    x = np.random.default_rng(0).normal(size=(2, 3, 64, 64)).astype(
        np.float32)
    net, _ = _held(m, x, 5e-4, kind=ForeignGraphNet)
    # the node names are the JAX converter's (a GraphNet path or a
    # checkpoint works in both packages)
    assert "layer4_1_relu_1.fn" not in dict(net.named_modules())
    assert "layer4_1_bn2" in dict(net.named_children())


def _first_step_grads(est, before, x, y):
    """The gradient tree of one sgd step at learning rate 1 from the
    weights ``before``: they less the weights after it."""
    est.fit((x, y), epochs=1, batch_size=len(x), verbose=False)
    return jax.tree_util.tree_map(lambda a, b: a - np.asarray(b), before,
                                  est.get_model()["params"])


def _torch_grads(m, x, y):
    """torch's own autograd of the same loss, batch norms in training
    mode, as a tree of the converters' names and layouts."""
    import copy
    tm = copy.deepcopy(m).train()
    loss = TNN.functional.cross_entropy(tm(torch.as_tensor(x)),
                                        torch.as_tensor(y).long())
    loss.backward()
    tree = {}
    for name, mod in tm.named_modules():
        key = name.replace(".", "_")
        if isinstance(mod, TNN.BatchNorm2d):
            tree[key] = {"gamma": mod.weight.grad.numpy(),
                         "beta": mod.bias.grad.numpy()}
        elif isinstance(mod, TNN.Conv2d):
            tree[key] = {"kernel":
                         mod.weight.grad.numpy().transpose(2, 3, 1, 0)}
        elif isinstance(mod, TNN.Linear):
            tree[key] = {"kernel": mod.weight.grad.numpy().T,
                         "bias": mod.bias.grad.numpy()}
    return tree


def test_load_torch_graph_finetunes_through_estimator():
    """The converted graph trains as a native model, batch norms in
    training mode; the fit held to the JAX ``from_torch`` fit.  sgd, as
    the card's phase trains, moves each weight by its gradient: the
    first step's gradients are held leaf by leaf to the JAX fit's and to
    torch's own autograd at GRAD_TOL of the leaf's largest (the three
    differ by f32 rounding, at most 1.4e-5 of it, measured), so a
    batch-norm backward that keeps only the gradients' signs fails; a
    four-step fit's losses at 1e-5.  adam's first loss is the converted
    weights' forward in training mode, at 1e-5."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        m = _resnet18_torch()
    x = np.random.default_rng(0).normal(size=(8, 3, 32, 32)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 10, 8).astype(np.int32)
    kw = dict(model=m, example_input=x,
              loss="sparse_categorical_crossentropy", optimizer="sgd")

    est = Estimator.from_torch(learning_rate=1.0, device="cpu", **kw)
    # the converted weights (the JAX converter's tree, as tested above)
    before = jax.tree_util.tree_map(np.array, est.get_model()["params"])
    grads = _first_step_grads(est, before, x, y)
    jgrads = _first_step_grads(
        JaxEstimator.from_torch(learning_rate=1.0, **kw), before, x, y)
    tgrads = _torch_grads(m, x, y)
    GRAD_TOL = 5e-5
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(tgrads))
    for path, g in flat:
        for ref in (jgrads, tgrads):
            want = np.asarray(functools.reduce(
                lambda t, k: t[k.key], path, ref))
            assert g.shape == want.shape
            scale = np.abs(want).max()
            assert np.abs(g - want).max() <= GRAD_TOL * scale, \
                jax.tree_util.keystr(path)

    # one step an epoch: four sgd steps at a rate whose trajectory the
    # packages' f32 rounding does not split beyond 1e-5
    est = Estimator.from_torch(learning_rate=3e-3, device="cpu", **kw)
    jest = JaxEstimator.from_torch(learning_rate=3e-3, **kw)
    assert isinstance(est.model, ForeignGraphNet)
    hist = est.fit((x, y), epochs=4, batch_size=8, verbose=False)
    jhist = jest.fit((x, y), epochs=4, batch_size=8, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=0,
                               atol=1e-5)
    # the running statistics moved by the JAX rule
    jstate = jax.device_get(jest._ts["state"])
    got = est.get_model()["state"]
    np.testing.assert_allclose(got["bn1"]["var"], jstate["bn1"]["var"],
                               rtol=1e-4, atol=1e-5)
    kw["optimizer"] = "adam"
    first = Estimator.from_torch(learning_rate=1e-3, device="cpu", **kw).fit(
        (x, y), epochs=1, batch_size=8, verbose=False)["loss"]
    jfirst = JaxEstimator.from_torch(learning_rate=1e-3, **kw).fit(
        (x, y), epochs=1, batch_size=8, verbose=False)["loss"]
    assert abs(first[0] - jfirst[0]) < 1e-5


def test_estimator_from_torch_reference_style_script():
    """A reference-style Orca script: a torch model through
    ``Estimator.from_torch``, then fit/evaluate/predict; losses held to
    the JAX ``from_torch`` fit."""
    model = TNN.Sequential(TNN.Linear(8, 32), TNN.ReLU(), TNN.Linear(32, 2))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=5e-3, metrics=["accuracy"], example_input=x[:4])
    est = Estimator.from_torch(model=model, device="cpu", **kw)
    jest = JaxEstimator.from_torch(model=model, **kw)
    assert isinstance(est.model, ForeignNet)
    hist = est.fit((x, y), epochs=8, batch_size=32, verbose=False)
    jhist = jest.fit((x, y), epochs=8, batch_size=32, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    res = est.evaluate((x, y), batch_size=32)
    assert res["accuracy"] > 0.7
    assert abs(res["loss"] - jest.evaluate((x, y), batch_size=32)["loss"]) \
        < 1e-5
    assert np.asarray(est.predict(x[:8], batch_size=8)).shape == (8, 2)


def test_estimator_from_torch_native_models_pass_through():
    """The rule: a model whose leaves are the port's layers passes through
    untouched; one with a ``torch.nn`` leaf is converted and needs
    ``example_input``."""
    from analytics_zoo_tpu_torch import nn as pnn
    native = pnn.Sequential([pnn.Dense(4, 3), pnn.Dense(3, 2)])
    est = Estimator.from_torch(model=native, loss="mse", device="cpu")
    assert est.model is native
    mixed = pnn.Sequential([pnn.Dense(4, 3), TNN.Linear(3, 2)])
    with pytest.raises(ValueError, match="example_input"):
        Estimator.from_torch(model=mixed, loss="mse", device="cpu")
    torch_net = TNN.Sequential(TNN.Linear(4, 2))
    est = Estimator.from_torch(model=torch_net, loss="mse", device="cpu",
                               example_input=np.zeros((2, 4), np.float32))
    assert isinstance(est.model, ForeignNet)


def test_fx_constant_first_binop_and_rsub():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.fc = TNN.Linear(4, 4)

        def forward(self, x):
            g = 1.0 - torch.sigmoid(self.fc(x))
            return torch.rsub(g, 2.0)

    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    _held(M(), x, 1e-5, graph=True, kind=ForeignGraphNet)


def test_fx_4d_constant_buffer_transposed_to_nhwc():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(3, 6, 3, padding=1)
            self.register_buffer("scale",
                                 torch.arange(1.0, 7.0).view(1, 6, 1, 1))

        def forward(self, x):
            return self.conv(x) * self.scale

    x = np.random.default_rng(1).normal(size=(2, 3, 6, 6)).astype(np.float32)
    net, _ = _held(M(), x, 1e-5, graph=True, kind=ForeignGraphNet)
    # the constant is a buffer that moves with the net, not a leaf of its
    # tree
    assert "_const_scale" not in net.state_dict()
    assert any(n == "_const_scale" for n, _ in net.named_buffers())


def test_fx_module_relu_between_flatten_and_linear_reorders_kernel():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(3, 4, 3, padding=1)
            self.flat = TNN.Flatten()
            self.act = TNN.ReLU()
            self.fc = TNN.Linear(4 * 5 * 5, 2)

        def forward(self, x):
            h = self.conv(x)
            h = h + h
            return self.fc(self.act(self.flat(h)))

    x = np.random.default_rng(2).normal(size=(2, 3, 5, 5)).astype(np.float32)
    _held(M(), x, 1e-5, graph=True, kind=ForeignGraphNet)


def test_fx_functional_pool_with_padding_and_ceil_mode():
    import torch.nn.functional as F

    class Pad(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(3, 4, 3, padding=1)

        def forward(self, x):
            return F.max_pool2d(self.conv(x) + 0.0, 3, 2, 1)

    x = np.random.default_rng(3).normal(size=(2, 3, 9, 9)).astype(np.float32)
    _held(Pad(), x, 1e-5, graph=True, kind=ForeignGraphNet)

    class Ceil(Pad):
        def forward(self, x):
            return F.max_pool2d(self.conv(x) + 0.0, 2, 2, ceil_mode=True)

    with pytest.raises(NotImplementedError, match="ceil_mode"):
        Net.load_torch_graph(Ceil().eval(), x)


def test_fx_view_size_flatten_pattern():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(3, 4, 3, padding=1)
            self.fc = TNN.Linear(4 * 5 * 5, 2)

        def forward(self, x):
            h = self.conv(x)
            h = h + h
            return self.fc(h.view(h.size(0), -1))

    x = np.random.default_rng(0).normal(size=(2, 3, 5, 5)).astype(np.float32)
    _held(M(), x, 1e-5, graph=True, kind=ForeignGraphNet)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_fx_softmax_axis_mapping_on_4d(dim):
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(3, 4, 1)

        def forward(self, x):
            h = self.conv(x)
            return torch.softmax(h + h, dim=dim)

    x = np.random.default_rng(1).normal(size=(2, 3, 4, 5)).astype(np.float32)
    _held(M(), x, 1e-5, graph=True, kind=ForeignGraphNet)


def test_fx_cat_of_flattened_branches_raises():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.c1 = TNN.Conv2d(3, 4, 1)
            self.c2 = TNN.Conv2d(3, 4, 1)
            self.fc = TNN.Linear(2 * 4 * 4 * 4, 2)

        def forward(self, x):
            a = torch.flatten(self.c1(x), 1)
            b = torch.flatten(self.c2(x), 1)
            return self.fc(torch.cat([a, b], dim=1))

    with pytest.raises(NotImplementedError, match="escape hatch"):
        Net.load_torch_graph(M().eval(), np.zeros((2, 3, 4, 4), np.float32))


def test_fx_densenet_style_channel_concat():
    class DenseBlock(TNN.Module):
        def __init__(self):
            super().__init__()
            self.c1 = TNN.Conv2d(3, 4, 3, padding=1)
            self.c2 = TNN.Conv2d(7, 4, 3, padding=1)
            self.pool = TNN.AdaptiveAvgPool2d(1)
            self.fc = TNN.Linear(11, 2)

        def forward(self, x):
            x1 = torch.cat([x, torch.relu(self.c1(x))], dim=1)
            x2 = torch.cat([x1, torch.relu(self.c2(x1))], dim=1)
            return self.fc(torch.flatten(self.pool(x2), 1))

    x = np.random.default_rng(4).normal(size=(2, 3, 8, 8)).astype(np.float32)
    _held(DenseBlock(), x, 1e-5, graph=True, kind=ForeignGraphNet)


def test_load_torch_rejects_flattened_plus_constant_chain():
    class M(TNN.Module):
        def __init__(self):
            super().__init__()
            self.conv = TNN.Conv2d(2, 3, 3)
            self.register_buffer("c", torch.randn(3 * 4 * 4))

        def forward(self, x):
            return torch.flatten(self.conv(x), 1) + self.c * 2.0

    x = np.random.default_rng(0).normal(size=(2, 2, 6, 6)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="constant"):
        Net.load_torch(M().eval(), x)


def test_import_loads_no_tensorflow():
    """Importing ``models/net.py`` (and the whole models package) loads no
    TensorFlow: only ``load_tf``, ``load_keras`` and ``from_graph`` import
    it."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, analytics_zoo_tpu_torch.models.net, "
            "analytics_zoo_tpu_torch.models, "
            "analytics_zoo_tpu_torch.orca.learn\n"
            "print(sorted(m for m in sys.modules if m == 'tensorflow' or "
            "m.startswith(('tensorflow.', 'keras'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- tf/keras ----------------------------------------------------------------

def _keras_held(km, x, atol, kind=ForeignNet, **call):
    net = Net.load_tf(km)
    assert isinstance(net, kind)
    xs = x if isinstance(x, list) else [x]
    got = _port(net, *xs)
    want = km(x, training=False).numpy()
    jout, jvars = _jax(JaxNet.load_tf(km), *xs)
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, jout, atol=atol)
    _same_tree(net, jvars)
    return net


def test_load_tf_mlp_differential():
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([
        tf.keras.layers.Input((8,)),
        tf.keras.layers.Dense(16, activation="relu"),
        tf.keras.layers.LayerNormalization(),
        tf.keras.layers.Dense(4, activation="softmax")])
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    _keras_held(km, x, 1e-5)


def test_load_tf_convnet_differential():
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([
        tf.keras.layers.Input((12, 12, 3)),
        tf.keras.layers.Conv2D(6, 3, padding="same", activation="relu"),
        tf.keras.layers.BatchNormalization(),
        tf.keras.layers.MaxPooling2D(2),
        tf.keras.layers.Conv2D(4, 3, padding="valid"),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10)])
    bn = km.layers[1]
    w = bn.get_weights()
    rng = np.random.default_rng(1)
    w[2] = rng.normal(0, 0.3, w[2].shape).astype(np.float32)
    w[3] = rng.uniform(0.5, 1.5, w[3].shape).astype(np.float32)
    bn.set_weights(w)
    x = rng.normal(size=(4, 12, 12, 3)).astype(np.float32)
    _keras_held(km, x, 1e-4)


def test_load_tf_from_saved_file(tmp_path):
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([tf.keras.layers.Input((6,)),
                              tf.keras.layers.Dense(3, activation="tanh")])
    path = str(tmp_path / "model.keras")
    km.save(path)
    x = np.random.default_rng(2).normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(_port(Net.load_tf(path), x), km(x).numpy(),
                               atol=1e-5)


def test_load_tf_unsupported_layer_names_escape_hatch():
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([tf.keras.layers.Input((4, 8)),
                              tf.keras.layers.LSTM(4)])
    with pytest.raises(NotImplementedError, match="escape hatch"):
        Net.load_tf(km)


def test_load_tf_functional_skip_differential():
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    inp = keras.Input((12, 12, 3))
    h = keras.layers.Conv2D(6, 3, padding="same", activation="relu",
                            name="c1")(inp)
    b = keras.layers.Conv2D(6, 3, padding="same", name="c2")(h)
    b = keras.layers.BatchNormalization(name="bn")(b)
    s = keras.layers.ReLU(name="relu")(keras.layers.Add(name="skip")([h, b]))
    p = keras.layers.GlobalAveragePooling2D(name="gap")(s)
    d1 = keras.layers.Dense(8, activation="relu", name="d1")(p)
    d2 = keras.layers.Dense(8, name="d2")(p)
    cat = keras.layers.Concatenate(name="cat")([d1, d2])
    model = keras.Model(inp, keras.layers.Dense(4, name="head")(cat))
    bn = model.get_layer("bn")
    w = bn.get_weights()
    w[2] = np.random.default_rng(0).normal(0, 0.5, w[2].shape).astype(
        np.float32)
    w[3] = np.abs(np.random.default_rng(1).normal(1.0, 0.3, w[3].shape)
                  ).astype(np.float32)
    bn.set_weights(w)
    x = np.random.default_rng(2).normal(size=(4, 12, 12, 3)).astype(
        np.float32)
    _keras_held(model, x, 1e-4, kind=ForeignGraphNet)


def test_load_tf_functional_shared_layer_names_escape_hatch():
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    inp = keras.Input((4,))
    shared = keras.layers.Dense(4, name="shared")
    model = keras.Model(inp, keras.layers.Add()([shared(inp),
                                                 shared(shared(inp))]))
    with pytest.raises(NotImplementedError, match="[Ss]hared"):
        Net.load_tf(model)


def test_estimator_from_graph_keras_model():
    """``from_graph`` converts a Keras model; its fit held to the JAX
    ``from_graph`` fit."""
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    m = keras.Sequential([keras.layers.Input((6,)),
                          keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dense(2)])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    kw = dict(loss="sparse_categorical_crossentropy", optimizer="adam",
              learning_rate=1e-3)
    est = Estimator.from_graph(m, device="cpu", **kw)
    hist = est.fit((x, y), epochs=2, batch_size=16, verbose=False)
    jhist = JaxEstimator.from_graph(m, **kw).fit((x, y), epochs=2,
                                                  batch_size=16,
                                                  verbose=False)
    assert len(hist["loss"]) == 2
    np.testing.assert_allclose(hist["loss"], jhist["loss"], atol=1e-5)
    native = Estimator.from_graph(est.model, device="cpu", **kw)
    assert native.model is est.model


def test_load_tf_functional_input_order_from_spec():
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    b = keras.Input((3,), name="in_b")
    a = keras.Input((3,), name="in_a")
    out = keras.layers.Subtract(name="sub")([
        keras.layers.Dense(3, name="da")(a),
        keras.layers.Dense(3, name="db")(b)])
    model = keras.Model([a, b], out)
    xa = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    xb = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    _keras_held(model, [xa, xb], 1e-5, kind=ForeignGraphNet)


def test_load_keras_named_entry_point():
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([tf.keras.layers.Input((6,)),
                              tf.keras.layers.Dense(4, activation="relu"),
                              tf.keras.layers.Dense(2)])
    x = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(_port(Net.load_keras(km), x), km(x).numpy(),
                               atol=1e-5)


def test_load_keras_json_def_plus_weights(tmp_path):
    tf = pytest.importorskip("tensorflow")
    km = tf.keras.Sequential([tf.keras.layers.Input((5,)),
                              tf.keras.layers.Dense(3, activation="tanh"),
                              tf.keras.layers.Dense(2)])
    d = tmp_path / "def.json"
    w = tmp_path / "weights.weights.h5"
    d.write_text(km.to_json())
    km.save_weights(str(w))
    x = np.random.default_rng(2).normal(size=(4, 5)).astype(np.float32)
    net = Net.load_keras(str(d), str(w))
    np.testing.assert_allclose(_port(net, x), km(x).numpy(), atol=1e-5)
    jout, _ = _jax(JaxNet.load_keras(str(d), str(w)), x)
    np.testing.assert_allclose(_port(net, x), jout, atol=1e-5)
