"""The port's ``data/augment2d.py`` against the JAX package's, on the CPU.

The deterministic ops run the same numpy images through both.  The random
ones run with JAX's draws: per sample, the test makes the same
``jax.random`` calls from the same keys as the JAX op (under its
``vmap`` over keys) and hands their values, in the order the port draws,
to the port's two draw functions (``_uniform``, ``_permutation``); each
handed value's shape is checked against the port's request.  Tolerance:
1e-5 relative to max(1, max |JAX|).  The port's own draws are held to
their laws: rates, ranges, permutations, reproducibility.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfe_mamba_tpu.data import augment2d as ja
from gfe_mamba_torch.data import augment2d as pa

torch.set_num_threads(2)
REL = 1e-5
U = jax.random.uniform


def _close(got, want, tag=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (tag, got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= REL, (tag, err)


def _imgs(seed, b=3, h=24, w=20):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


# JAX's draws of each op from its key, in the order the port draws them
def _jitter(key):
    kf, kp = jax.random.split(key)
    return [U(kf, (4,)), jax.random.permutation(kp, 4)]


def _coin(key):
    return [U(key, ())]


def _blur(key):
    ku, ks = jax.random.split(key)
    return [U(ks, ()), U(ku, ())]


def _crop(key):
    ka, kr, kij = jax.random.split(key, 3)
    return [U(ka, (10,)), U(kr, (10,)), U(kij, (2,))]


def _byol(key):
    kj, kjp, kg, kf, kb = jax.random.split(key, 5)
    return _jitter(kj) + _coin(kjp) + _coin(kg) + _coin(kf) + _blur(kb)


def _ssl(key):
    k1, k2, kl1, kl2, kg1, kg2 = jax.random.split(key, 6)
    return _byol(k1) + _byol(k2) + sum(map(_crop, (kl1, kl2, kg1, kg2)), [])


def _feed(monkeypatch, draws, keys):
    """Hand the port, call by call, the batch's stacked JAX draws."""
    per_sample = [draws(k) for k in keys]
    queue = iter([np.stack([np.asarray(s[i]) for s in per_sample])
                  for i in range(len(per_sample[0]))])

    def take(shape):
        value = next(queue)
        assert value.shape == tuple(shape), (value.shape, shape)
        return torch.from_numpy(value.astype(
            np.int64 if value.dtype.kind in "iu" else np.float32))

    monkeypatch.setattr(pa, "_uniform", lambda shape, g, d: take(shape))
    monkeypatch.setattr(pa, "_permutation",
                        lambda rows, n, g, d: take((rows, n)))
    return queue


def _random_case(monkeypatch, jax_op, draws, port_op, b=3, seed=0):
    imgs = _imgs(seed, b)
    keys = jax.random.split(jax.random.key(seed + 100), b)
    want = jax.vmap(jax_op)(keys, jnp.asarray(imgs))
    queue = _feed(monkeypatch, draws, keys)
    got = port_op(torch.from_numpy(imgs))
    assert next(queue, None) is None, "a JAX draw was left unused"
    return got, want


RANDOM_OPS = {
    "color_jitter": (ja.color_jitter, _jitter,
                     lambda x: pa.color_jitter(x, None)),
    "random_grayscale": (functools.partial(ja.random_grayscale, p=0.5),
                         _coin,
                         lambda x: pa.random_grayscale(x, None, 0.5)),
    "random_hflip": (ja.random_hflip, _coin,
                     lambda x: pa.random_hflip(x, None)),
    "random_gaussian_blur": (functools.partial(ja.random_gaussian_blur,
                                               p=0.6),
                             _blur,
                             lambda x: pa.random_gaussian_blur(x, None,
                                                               0.6)),
    "random_resized_crop": (lambda k, x: ja.random_resized_crop(
        k, x, 12, (0.08, 1.0)), _crop,
        lambda x: pa.random_resized_crop(x, None, 12, (0.08, 1.0))),
    "byol_augment": (lambda k, x: ja.byol_augment(k, x, 0.7, 0.4, 0.5),
                     _byol,
                     lambda x: pa.byol_augment(x, None, 0.7, 0.4, 0.5)),
}


@pytest.mark.parametrize("name", sorted(RANDOM_OPS))
def test_random_op_matches_jax(monkeypatch, name):
    jax_op, draws, port_op = RANDOM_OPS[name]
    got, want = _random_case(monkeypatch, jax_op, draws, port_op, b=6)
    _close(got, want, name)


def test_sample_crop_box_matches_jax(monkeypatch):
    """Boxes per sample, among them the fallback (a scale range no
    attempt can meet) and a wide image's ratio clamp."""
    for scale, hw in (((0.08, 1.0), (24, 20)), ((1.5, 2.0), (10, 30)),
                      ((1.5, 2.0), (30, 10))):
        keys = jax.random.split(jax.random.key(1), 8)
        want = jax.vmap(lambda k: ja.sample_crop_box(k, hw, scale))(keys)
        queue = _feed(monkeypatch, _crop, keys)
        got = pa.sample_crop_box(None, hw, scale, batch=8)
        assert next(queue, None) is None
        _close(got, want, f"{scale} {hw}")


def test_ssl_views_batch_matches_jax(monkeypatch):
    imgs = _imgs(3, 4)
    key = jax.random.key(7)
    want = ja.ssl_views_batch(key, jnp.asarray(imgs), 12)
    queue = _feed(monkeypatch, _ssl, jax.random.split(key, 4))
    got = pa.ssl_views_batch(torch.from_numpy(imgs), None, 12)
    assert next(queue, None) is None
    for g, w, name in zip(got, want, pa.SSLViews._fields):
        _close(g, w, name)


def test_ssl_views_one_image_matches_jax(monkeypatch):
    img = _imgs(4, 1)[0]
    key = jax.random.key(8)
    want = ja.ssl_views(key, jnp.asarray(img), 10,
                        local_upper_crop_scale=0.3,
                        global_lower_crop_scale=0.6)
    queue = _feed(monkeypatch, _ssl, [key])
    got = pa.ssl_views(torch.from_numpy(img), None, 10,
                       local_upper_crop_scale=0.3,
                       global_lower_crop_scale=0.6)
    assert next(queue, None) is None
    for g, w, name in zip(got, want, pa.SSLViews._fields):
        _close(g, w, name)


def test_color_ops_match_jax():
    x = _imgs(5, 2)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    hsv = np.array(ja.rgb_to_hsv(xj))
    _close(pa.rgb_to_hsv(xt), hsv, "rgb_to_hsv")
    _close(pa.hsv_to_rgb(torch.from_numpy(hsv)), ja.hsv_to_rgb(
        jnp.asarray(hsv)), "hsv_to_rgb")
    _close(pa.grayscale(xt), ja.grayscale(xj), "grayscale")
    for name, factor in (("brightness", 1.3), ("contrast", 0.6),
                         ("saturation", 1.7), ("hue", -0.3)):
        _close(getattr(pa, f"adjust_{name}")(xt[0], factor),
               getattr(ja, f"adjust_{name}")(xj[0], factor), name)
    _close(pa.normalize(xt), ja.normalize(xj), "normalize")
    _close(pa.gaussian_blur(xt[0], 1.4, 5), ja.gaussian_blur(xj[0], 1.4, 5),
           "gaussian_blur")


@pytest.mark.parametrize("box", [(3, 2, 12, 9), (2.6, 0.4, 17.3, 11.8)])
def test_crop_and_resize_matches_jax(box):
    """An integer box and a fractional one, up and down."""
    img = _imgs(6, 1)[0]
    for out in ((16, 6), (7, 13)):
        got = pa.crop_and_resize(torch.from_numpy(img),
                                 torch.tensor(box, dtype=torch.float32), out)
        _close(got, ja.crop_and_resize(jnp.asarray(img),
                                       jnp.asarray(box, jnp.float32), out),
               f"{box} {out}")
    m = pa._linear_resample_matrix(9, torch.tensor(2.5), torch.tensor(11.0),
                                   20)
    _close(m, ja._linear_resample_matrix(9, 2.5, 11.0, 20), "matrix")


def test_draw_laws():
    """The port's own draws: coins at their rates, flips mirror the image,
    the jitter's order a permutation, crop boxes inside the image with
    area and aspect in range, all reproducible from the seed."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(4000, 2, 3, 3, generator=gen)
    gray = pa.random_grayscale(x, torch.Generator().manual_seed(1), 0.3)
    is_gray = (gray[..., 0] == gray[..., 1]).flatten(1).all(1)
    assert abs(is_gray.double().mean().item() - 0.3) < 0.03
    flip = pa.random_hflip(x, torch.Generator().manual_seed(2))
    flipped = (flip == x.flip(-2)).flatten(1).all(1)
    assert ((flip == x).flatten(1).all(1) | flipped).all()
    assert abs(flipped.double().mean().item() - 0.5) < 0.03
    perm = pa._permutation(1000, 4, gen, "cpu")
    assert torch.equal(perm.sort(1).values, torch.arange(4).expand(1000, 4))
    boxes = [pa.sample_crop_box(torch.Generator().manual_seed(3), (60, 80),
                                (0.2, 0.6), batch=3000) for _ in range(2)]
    assert torch.equal(boxes[0], boxes[1])
    i, j, h, w = boxes[0].unbind(1)
    assert (i >= 0).all() and (j >= 0).all()
    assert (i + h <= 60).all() and (j + w <= 80).all()
    area = h * w / (60 * 80)
    assert area.min() > 0.18 and area.max() < 0.62
    ratio = w / h
    assert ratio.min() > 0.7 and ratio.max() < 1.43
    assert (i.std() > 1) and (j.std() > 1)
