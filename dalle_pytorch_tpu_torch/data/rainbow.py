"""Synthetic "rainbow shapes" dataset: compositional captions -> images.

Counterpart of the JAX package's `data/rainbow.py`, copied (numpy only),
so a seed gives bit-identical images, captions and batch order in both
packages. The images are anti-aliased shapes drawn from signed distances
on a black background; the captions are
"<size> [outline] [texture] <color> <shape> [rotation]" over 4 sizes, 2
fills, 3 textures, 12 colors, 8 shapes and 4 rotations: 9216 combos,
sampled without replacement in a seeded order so that each caption names
one image. Past 9216 samples the combos cycle with a small seeded
centre jitter (one caption then names several images).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

SIZE_RADII = {"tiny": 0.10, "small": 0.16, "large": 0.24, "huge": 0.32}
SIZES = tuple(SIZE_RADII)
COLORS = {
    "red": (0.9, 0.1, 0.1),
    "orange": (1.0, 0.55, 0.0),
    "yellow": (0.95, 0.9, 0.1),
    "green": (0.1, 0.75, 0.2),
    "cyan": (0.1, 0.8, 0.85),
    "blue": (0.15, 0.25, 0.9),
    "purple": (0.55, 0.15, 0.8),
    "pink": (0.95, 0.5, 0.7),
    "white": (0.95, 0.95, 0.95),
    "gray": (0.55, 0.55, 0.55),
    "brown": (0.55, 0.33, 0.12),
    "magenta": (0.85, 0.1, 0.85),
}
SHAPES = (
    "circle", "square", "triangle", "rhombus",
    "rectangle", "star", "hexagon", "cross",
)
FILLS = ("", "outline")  # "" = filled (like the notebook's unnamed default)
TEXTURES = ("", "striped", "checker")
ROTATIONS = ("", "rotated", "rotated twice", "rotated thrice")


def _sdf(shape: str, dx: np.ndarray, dy: np.ndarray, r: float) -> np.ndarray:
    """Signed distance (px) to the shape boundary; negative = inside."""
    if shape == "circle":
        return np.sqrt(dx**2 + dy**2) - r
    if shape == "square":
        return np.maximum(np.abs(dx), np.abs(dy)) - r * 0.9
    if shape == "triangle":
        h = r * 1.2
        d1 = dy - h * 0.6
        d2 = 0.866 * dx + 0.5 * dy - h * 0.6
        d3 = -0.866 * dx + 0.5 * dy - h * 0.6
        return np.maximum.reduce([d1, d2, d3])
    if shape == "rhombus":  # narrow diamond (distinct from a rotated square)
        return (np.abs(dx) * 1.6 + np.abs(dy)) * 0.75 - r
    if shape == "rectangle":  # wide: half-width r, half-height r/2.2
        return np.maximum(np.abs(dx), np.abs(dy) * 2.2) - r
    if shape == "star":  # hexagram = union of up and down triangles
        up = _sdf("triangle", dx, dy, r)
        down = _sdf("triangle", dx, -dy, r)
        return np.minimum(up, down)
    if shape == "hexagon":
        return (
            np.maximum(0.866 * np.abs(dx) + 0.5 * np.abs(dy), np.abs(dy))
            - r * 0.9
        )
    if shape == "cross":  # union of a wide and a tall bar
        wide = np.maximum(np.abs(dx), np.abs(dy) * 2.8) - r
        tall = np.maximum(np.abs(dx) * 2.8, np.abs(dy)) - r
        return np.minimum(wide, tall)
    raise ValueError(f"unknown shape {shape}")


def render_shape(
    shape: str,
    color: Tuple[float, float, float],
    size: str,
    image_size: int = 32,
    jitter: Tuple[float, float] = (0.0, 0.0),
    *,
    fill: str = "",
    texture: str = "",
    rotation: int = 0,
) -> np.ndarray:
    """Render one anti-aliased shape on a black background. [H, W, 3] in [0,1].

    ``fill="outline"`` draws only a ~2 px interior ring; ``texture`` dims
    alternating stripes/checker cells; ``rotation`` is the number of 90°
    turns applied to the rendered image (mirrors the notebook's np.rot90
    post-pass, cell 7).
    """
    n = image_size
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) + 0.5
    cx = n / 2 + jitter[0] * n * 0.1
    cy = n / 2 + jitter[1] * n * 0.1
    r = n * SIZE_RADII[size]

    dist = _sdf(shape, xx - cx, yy - cy, r)
    if fill == "outline":
        # band centered 1 px inside the boundary, ~2 px wide
        alpha = np.clip(0.5 - (np.abs(dist + 1.0) - 1.0), 0.0, 1.0)
    else:
        alpha = np.clip(0.5 - dist, 0.0, 1.0)  # 1px anti-alias band

    if texture == "striped":
        tex = np.where((yy.astype(np.int64) // 2) % 2 == 0, 1.0, 0.3)
    elif texture == "checker":
        tex = np.where(
            ((xx.astype(np.int64) // 3) + (yy.astype(np.int64) // 3)) % 2 == 0,
            1.0, 0.3,
        )
    else:
        tex = 1.0

    img = np.zeros((n, n, 3))
    shade = alpha * tex
    for c in range(3):
        img[..., c] = shade * color[c]
    if rotation:
        img = np.rot90(img, rotation, axes=(0, 1)).copy()
    return img.astype(np.float32)


def _all_combos():
    return [
        {"size": s, "fill": f, "texture": t, "color": c, "shape": sh,
         "rotation": rot}
        for s in SIZES
        for f in FILLS
        for t in TEXTURES
        for c in COLORS
        for sh in SHAPES
        for rot in range(len(ROTATIONS))
    ]


@dataclass
class RainbowDataset:
    """Deterministic caption->image dataset (caption-unique cross-product).

    Up to 9,216 unique (size, fill, texture, color, shape, rotation) combos
    are sampled without replacement in a seed-shuffled order, so every
    caption maps to exactly one image — the property behind the reference
    notebook's exact-match bar. Past the combo count, combos cycle with a
    small deterministic center jitter (caption-ambiguous; see module doc).
    """

    num_samples: int = 1024
    image_size: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        combos = _all_combos()
        order = rng.permutation(len(combos))
        idx = order[np.arange(self.num_samples) % len(combos)]
        self._combos = [combos[i] for i in idx]
        self.unique = self.num_samples <= len(combos)
        if self.unique:
            self._jitter = np.zeros((self.num_samples, 2))
        else:
            self._jitter = rng.uniform(-1, 1, size=(self.num_samples, 2))

    def __len__(self) -> int:
        return self.num_samples

    def caption(self, i: int) -> str:
        c = self._combos[i]
        words = [c["size"], c["fill"], c["texture"], c["color"], c["shape"],
                 ROTATIONS[c["rotation"]]]
        return " ".join(w for w in words if w)

    def image(self, i: int) -> np.ndarray:
        c = self._combos[i]
        return render_shape(
            c["shape"], COLORS[c["color"]], c["size"], self.image_size,
            tuple(self._jitter[i]), fill=c["fill"], texture=c["texture"],
            rotation=c["rotation"],
        )

    def __getitem__(self, i: int):
        return self.caption(i), self.image(i)

    def batches(self, batch_size: int, tokenizer, text_seq_len: int, *,
                shuffle_seed: int | None = None, shard: Tuple[int, int] = (0, 1),
                drop_last: bool = True, start_batch: int = 0):
        """Yield {"text": [B,T] int32, "images": [B,H,W,3] float32,
        "captions": [B] str} batches; `shard=(i, n)` gives process i of n
        its interleaved subset, `start_batch` skips that many batches."""
        from dalle_pytorch_tpu_torch.data.loader import host_shard_order

        order = np.arange(self.num_samples)
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(order)
        order = host_shard_order(order, shard)
        for start in range(start_batch * batch_size, len(order), batch_size):
            sel = order[start : start + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            texts = [self.caption(i) for i in sel]
            yield {
                "text": tokenizer.tokenize(texts, text_seq_len, truncate_text=True),
                "images": np.stack([self.image(i) for i in sel]),
                "captions": texts,
            }
