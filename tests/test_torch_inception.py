"""The port's InceptionV3 feature extractor (``image/inception_net.py``) and
the shared weight I/O (``utils/params_io.py``) against the JAX package's, on
the CPU.

The JAX net's ``init_params(0)`` variables (its ``init`` under ``jax.jit``,
the same values) are carried across with
``inception_params_from_jax``; the same seeded uint8 images go through one
JAX forward (all taps, shared by the tests of this module) and through the
port at an upsampled size (32 x 32) and a downsampled one (512 x 512), where
``jax.image.resize`` antialiases and the port's ``F.interpolate(...,
antialias=True)`` must follow it. Every tap within rtol 1e-4 and an absolute
1e-4 of the tap's largest value (the random flax weights shrink the deep
taps to ~1e-3: an absolute floor of 1e-4 would hide an error there).

The weights-file path is held against the repo's independent torch oracle:
a torchvision-layout random state dict, converted by
``tools/convert_inception_weights``, written by the port's ``save_params``
and read through ``$METRICS_TPU_INCEPTION_WEIGHTS``, gives every tap of
``tools/torch_inception_module.module_forward`` (two torch forwards in
float32: rtol 1e-5, an absolute 1e-5 of the tap's scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu.image import inception_net as jax_net
from metrics_tpu.utils import params_io as jax_io
from metrics_tpu_torch.image import inception_net as port_net
from metrics_tpu_torch.utils import params_io as port_io

TAPS = [64, 192, 768, 2048, "logits", "logits_unbiased"]
SIZES = [32, 512]


def _images(size, n=2, seed=None):
    rng = np.random.default_rng(size if seed is None else seed)
    return rng.integers(0, 256, size=(n, 3, size, size), dtype=np.uint8)


@jax.jit
def _jax_taps(variables, imgs):
    """The JAX extractor's ``_forward`` for every tap at once (its keys as str)."""
    x = jnp.transpose(jnp.asarray(imgs, jnp.float32), (0, 2, 3, 1))
    x = jax.image.resize(x, (x.shape[0], 299, 299, x.shape[3]), method="bilinear")
    x = x / 255.0 * 2.0 - 1.0
    return {str(k): v for k, v in jax_net.InceptionV3().apply(variables, x).items()}


@pytest.fixture(scope="module")
def carried():
    # ``jax_net.init_params(0)`` compiled: the same variables bit for bit, in half the time
    variables = jax.jit(jax_net.InceptionV3().init)(jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3), jnp.float32))
    numpy_tree = jax.tree_util.tree_map(np.asarray, variables)
    net = port_net.InceptionV3()
    net.load_state_dict(port_io.inception_params_from_jax(numpy_tree), strict=True)
    net.eval()
    taps = {size: {k: np.asarray(v) for k, v in _jax_taps(variables, jnp.asarray(_images(size))).items()}
            for size in SIZES}
    return net, numpy_tree, taps


def _close(got, want, rtol=1e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("tap", TAPS)
def test_every_tap_matches_the_jax_net(carried, size, tap):
    net, _, taps = carried
    got = port_net._forward(net, tap, torch.from_numpy(_images(size)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, port_net.FEATURE_DIMS[tap])
    _close(got.numpy(), taps[size][str(tap)])


def test_one_forward_gives_every_tap(carried):
    net, _, taps = carried
    x = torch.nn.functional.interpolate(torch.from_numpy(_images(32)).float(), size=(299, 299), mode="bilinear",
                                        antialias=True) / 255.0 * 2.0 - 1.0
    with torch.no_grad():
        out = net(x)
    assert sorted(out, key=str) == sorted(TAPS, key=str)
    for tap in TAPS:
        _close(out[tap].numpy(), taps[32][str(tap)])


def test_the_state_dict_keys_are_the_flax_leaves(carried):
    _, tree, _ = carried
    state = port_io.inception_params_from_jax(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(state) == n_leaves == len(port_net.InceptionV3().state_dict())
    assert tuple(state["Conv2d_1a_3x3.conv.weight"].shape) == (32, 3, 3, 3)
    assert tuple(state["fc.weight"].shape) == (1008, 2048)
    np.testing.assert_array_equal(state["Mixed_7c.branch_pool.bn.running_var"].numpy(),
                                  tree["batch_stats"]["Mixed_7c"]["branch_pool"]["bn"]["var"])


def test_a_jax_weights_file_loads_in_the_port(carried, tmp_path):
    """A file written by the JAX package's ``save_params`` reads back with the
    port's ``load_params`` (numpy, equal leaves) and drives the extractor."""
    net, tree, taps = carried
    path = str(tmp_path / "inception.npz")
    jax_io.save_params(tree, path)
    loaded = port_io.load_params(path)
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(tree)):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b)
    extractor = port_net.InceptionFeatureExtractor(768, weights_path=path, device="cpu")
    _close(extractor(torch.from_numpy(_images(32))).numpy(), taps[32]["768"])


def test_the_port_save_params_writes_the_jax_format(carried, tmp_path):
    _, tree, _ = carried
    path = str(tmp_path / "port.npz")
    port_io.save_params(tree, path)
    again = jax_io.load_params(path)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(np.asarray(a), b)


def test_the_weights_file_path_matches_the_independent_torch_oracle(tmp_path, monkeypatch):
    from tools.convert_inception_weights import convert_state_dict
    from tools.torch_inception_fid import random_state_dict
    from tools.torch_inception_module import module_forward

    sd = random_state_dict(seed=3)
    path = str(tmp_path / "converted.npz")
    port_io.save_params(convert_state_dict(sd), path)
    monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", path)
    imgs = _images(299, seed=4)
    want = module_forward(sd, imgs)
    for tap in TAPS:
        got = port_net.InceptionFeatureExtractor(tap, device="cpu")(torch.from_numpy(imgs)).numpy()
        scale = max(1.0, float(np.abs(want[tap]).max()))
        np.testing.assert_allclose(got, want[tap], rtol=1e-5, atol=1e-5 * scale)


def test_random_weights_are_seeded_and_the_same_on_every_call():
    a, b, c = port_net.init_params(0), port_net.init_params(0), port_net.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Mixed_5b.branch1x1.conv.weight"], c["Mixed_5b.branch1x1.conv.weight"])
    assert torch.equal(a["Conv2d_1a_3x3.bn.running_var"], torch.ones(32))
    with pytest.warns(UserWarning, match="RANDOM weights"):
        port_net._cached_state.cache_clear()
        port_net._cached_net.cache_clear()
        extractor = port_net.InceptionFeatureExtractor(64, seed=5, allow_random_weights=True, device="cpu")
    out = extractor(torch.from_numpy(_images(75, n=3)))
    assert tuple(out.shape) == (3, 64) and bool(torch.isfinite(out).all())


def test_the_errors_of_the_jax_extractor(monkeypatch, tmp_path):
    monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS", raising=False)
    for make in (jax_net.InceptionFeatureExtractor, port_net.InceptionFeatureExtractor):
        with pytest.raises(ValueError, match="`feature` must be one of"):
            make(100, allow_random_weights=True)
        with pytest.raises(FileNotFoundError, match="No InceptionV3 weights"):
            make(64)
        with pytest.raises(FileNotFoundError, match="not found"):
            make(64, weights_path=str(tmp_path / "missing.npz"))
        monkeypatch.setenv("METRICS_TPU_INCEPTION_WEIGHTS", str(tmp_path / "missing_env.npz"))
        with pytest.raises(FileNotFoundError, match="not found"):
            make(64)
        monkeypatch.delenv("METRICS_TPU_INCEPTION_WEIGHTS")


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_net.InceptionFeatureExtractor(64, allow_random_weights=True)
