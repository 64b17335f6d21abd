"""The port's LPIPS network and metric (``image/lpips_net.py``, ``image/lpip.py``)
against the JAX package's, on the CPU.

The JAX net's ``init_params(net_type, 0)`` variables (its ``init`` under
``jax.jit``: the same values) are carried across with
``lpips_params_from_jax`` for all three backbones, and the same seeded images
in [-1, 1] go through both at odd sizes (65 x 65, and 35 x 35 for
SqueezeNet, whose ceil-mode pools keep a window hanging over the edge).
Distances within rtol 1e-4, atol 1e-6 (two float32 convolution stacks).
``nn.MaxPool2d(ceil_mode=True)`` equals the JAX package's ``-inf`` padded
pool exactly.

The weights-file path is held against the repo's independent torch oracle:
``tools/torch_lpips_ref.random_state_dicts`` converted by
``tools/convert_lpips_weights.build_params``, written by the port's
``save_params`` and loaded by ``make_distance_fn``, gives
``tools/torch_lpips_ref.torch_lpips_distance`` (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu.image as jax_img
import metrics_tpu_torch.image as port_img
from metrics_tpu.image import lpips_net as jax_net
from metrics_tpu_torch.image import lpips_net as port_net
from metrics_tpu_torch.utils import params_io as port_io

NETS = ["alex", "vgg", "squeeze"]
CPU = {"device": "cpu"}


def _pair(seed, n=2, size=65):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, size=(n, 3, size, size)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def carried():
    out = {}
    dummy = jnp.zeros((1, 3, 64, 64), jnp.float32)
    for net_type in NETS:
        model = jax_net.LPIPSNet(net_type=net_type)
        variables = jax.jit(model.init)(jax.random.PRNGKey(0), dummy, dummy)  # jax_net.init_params(net_type, 0)
        tree = jax.tree_util.tree_map(np.asarray, variables)
        net = port_net.LPIPSNet(net_type)
        net.load_state_dict(port_io.lpips_params_from_jax(tree, net_type), strict=True)
        out[net_type] = (model, variables, tree, net.eval())
    return out


@pytest.mark.parametrize("net_type", NETS)
@pytest.mark.parametrize("size", [65, 35])
def test_distances_match_the_jax_net(carried, net_type, size):
    model, variables, _, net = carried[net_type]
    img0, img1 = _pair(size)
    want = np.asarray(model.apply(variables, jnp.asarray(img0), jnp.asarray(img1)))
    with torch.no_grad():
        got = net(torch.from_numpy(img0), torch.from_numpy(img1))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    with torch.no_grad():
        assert float(net(torch.from_numpy(img0), torch.from_numpy(img0)).abs().max()) < 1e-7


@pytest.mark.parametrize("size", [7, 8, 13, 16, 33])
def test_ceil_mode_pool_equals_the_jax_padded_pool(size):
    x = np.random.default_rng(size).normal(size=(2, 5, size, size + 2)).astype(np.float32)
    want = np.asarray(jax_net._max_pool_ceil(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = torch.nn.MaxPool2d(3, 2, ceil_mode=True)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net_type", NETS)
def test_a_jax_weights_file_drives_the_port_metric(carried, net_type, tmp_path, monkeypatch):
    model, variables, tree, _ = carried[net_type]
    path = str(tmp_path / f"{net_type}.npz")
    jax_net.save_params(tree, path)
    monkeypatch.setenv("METRICS_TPU_LPIPS_WEIGHTS", path)
    img0, img1 = _pair(3, n=3, size=64)
    for reduction in ("mean", "sum"):
        ref = jax_img.LearnedPerceptualImagePatchSimilarity(net_type, reduction=reduction, normalize=True)
        port = port_img.LearnedPerceptualImagePatchSimilarity(net_type, reduction=reduction, normalize=True, **CPU)
        for a, b in ((img0, img1), (img1[:2], img0[:2])):
            a01, b01 = (a + 1) / 2, (b + 1) / 2
            ref.update(jnp.asarray(a01), jnp.asarray(b01))
            port.update(torch.from_numpy(a01), torch.from_numpy(b01))
        for name in ("sum_scores", "total"):
            got, want = getattr(port, name), np.asarray(getattr(ref, name))
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-4, atol=1e-6)


def test_the_weights_file_path_matches_the_independent_torch_oracle(tmp_path):
    from tools.convert_lpips_weights import build_params
    from tools.torch_lpips_ref import random_state_dicts, torch_lpips_distance

    backbone_sd, lpips_sd = random_state_dicts("alex", seed=4)
    path = str(tmp_path / "alex.npz")
    port_io.save_params(build_params(backbone_sd, lpips_sd, "alex"), path)
    img0, img1 = _pair(6, size=64)
    want = torch_lpips_distance(backbone_sd, lpips_sd, "alex", img0, img1)
    with torch.no_grad():
        got = port_net.make_distance_fn("alex", weights_path=path, device="cpu")(torch.from_numpy(img0),
                                                                                 torch.from_numpy(img1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (want > 0).all()


def test_a_weights_file_of_another_backbone_raises_in_both(carried, tmp_path):
    path = str(tmp_path / "alex.npz")
    jax_net.save_params(carried["alex"][2], path)
    for make in (jax_net.make_distance_fn, port_net.make_distance_fn):
        with pytest.raises(ValueError, match="do not match net_type='vgg'"):
            make("vgg", weights_path=path)


def test_random_weights_are_seeded_and_need_opting_in(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_LPIPS_WEIGHTS", raising=False)
    a, b = port_net.init_params("squeeze", 1), port_net.init_params("squeeze", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["lin0"].min()) >= 0 and float(a["features.fire2.squeeze.bias"].abs().max()) == 0
    for make in (jax_net.make_distance_fn, port_net.make_distance_fn):
        with pytest.raises(FileNotFoundError, match="No LPIPS weights"):
            make("alex")
        with pytest.raises(ValueError, match="net_type"):
            make("resnet", allow_random_weights=True)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        dist = port_net.make_distance_fn("vgg", allow_random_weights=True, device="cpu")
    img0, img1 = _pair(9, size=32)
    d = dist(torch.from_numpy(img0), torch.from_numpy(img1))
    assert tuple(d.shape) == (2,) and bool((d > 0).all())


ERRORS = [
    ({"net_type": "resnet"}, ValueError),
    ({"backend": "torch"}, ValueError),
    ({"reduction": "none"}, ValueError),
    ({"normalize": 1}, ValueError),
    ({"backend": "lpips"}, ModuleNotFoundError),  # the lpips package is not installed
    ({}, FileNotFoundError),  # no weights, no opt-in
]


@pytest.mark.parametrize("kw,err", ERRORS)
def test_the_argument_errors_of_the_jax_package(monkeypatch, kw, err):
    from metrics_tpu_torch.utils.imports import _LPIPS_AVAILABLE

    assert not _LPIPS_AVAILABLE
    monkeypatch.delenv("METRICS_TPU_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(err):
        jax_img.LearnedPerceptualImagePatchSimilarity(**kw)
    with pytest.raises(err):
        port_img.LearnedPerceptualImagePatchSimilarity(**kw, **CPU)


def test_a_callable_distance_and_its_states():
    def jax_dist(a, b):
        return jnp.mean((a - b) ** 2, axis=(1, 2, 3))

    def port_dist(a, b):
        return torch.mean((a - b) ** 2, dim=(1, 2, 3))

    ref = jax_img.LearnedPerceptualImagePatchSimilarity(distance_fn=jax_dist, reduction="sum")
    port = port_img.LearnedPerceptualImagePatchSimilarity(distance_fn=port_dist, reduction="sum", **CPU)
    for seed in range(3):
        a, b = _pair(seed, n=4, size=9)
        ref.update(jnp.asarray(a), jnp.asarray(b))
        port.update(torch.from_numpy(a), torch.from_numpy(b))
    assert float(port.total) == float(ref.total) == 12.0
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-6)
