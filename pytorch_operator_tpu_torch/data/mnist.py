"""MNIST input pipeline: IDX files when present, procedural digits otherwise.

The port's own copy of ``pytorch_operator_tpu/data/mnist.py`` (numpy
only, so the arrays are bitwise the JAX package's for the same seed and
sizes).  Where no dataset can be fetched, the loader makes a
deterministic, *learnable* synthetic digit set: 7x5 bitmap-font glyphs
rendered into 28x28 with a random shift, intensity jitter and pixel
noise.  A CNN reaches >98% on it, which keeps the ``accuracy={:.4f}``
success signal of the MNIST example meaningful.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# 7 rows x 5 cols bitmap font for digits 0-9
_GLYPHS = [
    ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],  # 0
    ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],  # 1
    ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],  # 2
    ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],  # 3
    ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],  # 4
    ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],  # 5
    ["01110", "10000", "10000", "11110", "10001", "10001", "01110"],  # 6
    ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],  # 7
    ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],  # 8
    ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],  # 9
]


def _glyph_array(digit: int) -> np.ndarray:
    rows = _GLYPHS[digit]
    return np.array([[c == "1" for c in row] for row in rows], np.float32)


def synthetic(
    n: int, *, seed: int = 0, image_size: int = 28
) -> tuple[np.ndarray, np.ndarray]:
    """Generate n (image, label) pairs; images (n, 28, 28, 1) in [0, 1]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    # upscale 7x5 glyph to 21x15, place at random offset in 28x28
    images = np.zeros((n, image_size, image_size, 1), np.float32)
    glyphs = [np.kron(_glyph_array(d), np.ones((3, 3), np.float32)) for d in range(10)]
    gh, gw = glyphs[0].shape
    max_y, max_x = image_size - gh, image_size - gw
    ys = rng.integers(0, max_y + 1, n)
    xs = rng.integers(0, max_x + 1, n)
    intensity = rng.uniform(0.6, 1.0, n).astype(np.float32)
    for i in range(n):
        images[i, ys[i]:ys[i] + gh, xs[i]:xs[i] + gw, 0] = (
            glyphs[labels[i]] * intensity[i]
        )
    images += rng.normal(0.0, 0.08, images.shape).astype(np.float32)
    np.clip(images, 0.0, 1.0, out=images)
    return images, labels.astype(np.int32)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def load(
    data_dir: str | None = None,
    *,
    split: str = "train",
    synthetic_size: int = 16384,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Load (images, labels); images float32 (N, 28, 28, 1) in [0, 1].

    Looks for the standard IDX files (optionally .gz) under ``data_dir``;
    falls back to :func:`synthetic` when absent.
    """
    prefix = "train" if split == "train" else "t10k"
    if data_dir:
        for suffix in ("", ".gz"):
            img_path = os.path.join(
                data_dir, f"{prefix}-images-idx3-ubyte{suffix}")
            lbl_path = os.path.join(
                data_dir, f"{prefix}-labels-idx1-ubyte{suffix}")
            if os.path.exists(img_path) and os.path.exists(lbl_path):
                images = _read_idx(img_path).astype(np.float32) / 255.0
                labels = _read_idx(lbl_path).astype(np.int32)
                return images[..., None], labels
        # explicit data_dir with no usable files must not silently become
        # synthetic data — the accuracy log line is an e2e success signal
        raise FileNotFoundError(
            f"no MNIST idx files ({prefix}-images-idx3-ubyte[.gz]) under "
            f"{data_dir!r}; omit --data-dir to use the synthetic dataset"
        )
    if split != "train":
        seed += 1_000_003  # disjoint synthetic eval set
    return synthetic(synthetic_size, seed=seed)


def batches(images, labels, batch_size: int, *, seed: int = 0, drop_last=True):
    """Shuffled batch iterator (one epoch)."""
    n = len(images)
    order = np.random.default_rng(seed).permutation(n)
    end = n - n % batch_size if drop_last else n
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield images[idx], labels[idx]
