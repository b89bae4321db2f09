"""CNN image classifiers (DeepBoof-equivalent).

Reference analog: boofcv-recognition deepboof/ImageClassifierVggCifar10
.java and ImageClassifierNiNImageNet.java — thin inference wrappers
around pretrained networks (VGG-like CIFAR-10, Network-in-Network
ImageNet) with fixed preprocessing (resize, mean/std normalize).

Design: the forward pass is a stack of XLA `conv_general_dilated`
calls in NHWC — exactly what matmul units are for; parameters are a flat dict
of arrays loadable from .npz (the reference downloads serialized torch
models; offline environments initialize randomly and load weights from
disk when available).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


# VGG-ish CIFAR-10 topology used by DeepBoof's pretrained model:
# conv3x3(64)x2-pool conv3x3(128)x2-pool conv3x3(256)x2-pool -> fc
VGG_CIFAR10_CHANNELS: Tuple[Tuple[int, ...], ...] = ((64, 64), (128, 128),
                                                     (256, 256))
CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer",
                   "dog", "frog", "horse", "ship", "truck")


def _conv(x, w, b):
    y = lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    return y + b


def _maxpool2(x):
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def init_vgg_cifar10(key, num_classes: int = 10,
                     image_size: int = 32) -> Dict[str, jnp.ndarray]:
    """He-normal initialized parameter dict (stand-in until real weights
    are loaded with :func:`load_params`)."""
    params = {}
    cin = 3
    k = key
    for bi, block in enumerate(VGG_CIFAR10_CHANNELS):
        for ci, cout in enumerate(block):
            k, sub = jax.random.split(k)
            std = float(np.sqrt(2.0 / (3 * 3 * cin)))
            params[f"conv{bi}_{ci}_w"] = (
                jax.random.normal(sub, (3, 3, cin, cout), jnp.float32) * std)
            params[f"conv{bi}_{ci}_b"] = jnp.zeros((cout,), jnp.float32)
            cin = cout
    feat = image_size // (2 ** len(VGG_CIFAR10_CHANNELS))
    fdim = feat * feat * cin
    k, s1, s2 = jax.random.split(k, 3)
    params["fc0_w"] = jax.random.normal(s1, (fdim, 512),
                                        jnp.float32) * float(
                                            np.sqrt(2.0 / fdim))
    params["fc0_b"] = jnp.zeros((512,), jnp.float32)
    params["fc1_w"] = jax.random.normal(s2, (512, num_classes),
                                        jnp.float32) * float(
                                            np.sqrt(2.0 / 512))
    params["fc1_b"] = jnp.zeros((num_classes,), jnp.float32)
    return params


def vgg_cifar10_forward(params: Dict[str, jnp.ndarray], images):
    """Batched forward: images [N, H, W, 3] float in [0, 1] -> logits."""
    x = images.astype(jnp.float32)
    for bi, block in enumerate(VGG_CIFAR10_CHANNELS):
        for ci, _ in enumerate(block):
            x = jax.nn.relu(_conv(x, params[f"conv{bi}_{ci}_w"],
                                  params[f"conv{bi}_{ci}_b"]))
        x = _maxpool2(x)
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(x @ params["fc0_w"] + params["fc0_b"])
    return x @ params["fc1_w"] + params["fc1_b"]


# Network-in-Network: conv blocks with 1x1 "mlpconv" layers and global
# average pooling instead of fc (ImageClassifierNiNImageNet topology,
# scaled by `channels`).
def init_nin(key, num_classes: int = 1000,
             channels: Sequence[int] = (96, 256, 384)) -> Dict[str, jnp.ndarray]:
    params = {}
    cin = 3
    k = key
    sizes = (11, 5, 3)
    strides = (4, 1, 1)
    for bi, (cout, ks, _st) in enumerate(zip(channels, sizes, strides)):
        for ci, (kk, co) in enumerate(((ks, cout), (1, cout), (1, cout))):
            k, sub = jax.random.split(k)
            std = float(np.sqrt(2.0 / (kk * kk * cin)))
            params[f"nin{bi}_{ci}_w"] = (
                jax.random.normal(sub, (kk, kk, cin, co), jnp.float32) * std)
            params[f"nin{bi}_{ci}_b"] = jnp.zeros((co,), jnp.float32)
            cin = co
    k, sub = jax.random.split(k)
    params["head_w"] = jax.random.normal(
        sub, (1, 1, cin, num_classes), jnp.float32) * float(
            np.sqrt(2.0 / cin))
    params["head_b"] = jnp.zeros((num_classes,), jnp.float32)
    return params


def nin_forward(params: Dict[str, jnp.ndarray], images,
                channels: Sequence[int] = (96, 256, 384)):
    """images [N, H, W, 3] -> logits via mlpconv blocks + global avg pool."""
    x = images.astype(jnp.float32)
    strides = (4, 1, 1)
    for bi, _ in enumerate(channels):
        for ci in range(3):
            w = params[f"nin{bi}_{ci}_w"]
            st = strides[bi] if ci == 0 else 1
            x = lax.conv_general_dilated(
                x, w, window_strides=(st, st), padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.float32)
            x = jax.nn.relu(x + params[f"nin{bi}_{ci}_b"])
        if bi < len(channels) - 1:
            x = _maxpool2(x)
    x = _conv(x, params["head_w"], params["head_b"])
    return jnp.mean(x, axis=(1, 2))


def save_params(path: str, params: Dict[str, jnp.ndarray]) -> None:
    np.savez_compressed(path, **{k: np.asarray(v)
                                 for k, v in params.items()})


def load_params(path: str) -> Dict[str, jnp.ndarray]:
    z = np.load(path)
    return {k: jnp.asarray(z[k]) for k in z.files}


class ImageClassifierVggCifar10:
    """Host wrapper (ImageClassifierVggCifar10.java): holds params, a
    jitted forward, per-channel normalization, classify() -> best class."""

    def __init__(self, params: Dict[str, jnp.ndarray] | None = None,
                 mean=(0.4914, 0.4822, 0.4465),
                 std=(0.247, 0.243, 0.262), seed: int = 0):
        self.params = params if params is not None else init_vgg_cifar10(
            jax.random.PRNGKey(seed))
        self.mean = jnp.asarray(mean, jnp.float32)
        self.std = jnp.asarray(std, jnp.float32)
        self._fwd = jax.jit(vgg_cifar10_forward)

    def scores(self, image) -> np.ndarray:
        """image [32, 32, 3] (or batch [N, 32, 32, 3]) in [0, 255]/[0, 1]."""
        x = jnp.asarray(image, jnp.float32)
        if x.ndim == 3:
            x = x[None]
        if float(jnp.max(x)) > 2.0:
            x = x / 255.0
        x = (x - self.mean) / self.std
        return np.asarray(jax.nn.softmax(self._fwd(self.params, x), -1))

    def classify(self, image) -> int:
        return int(np.argmax(self.scores(image)[0]))
