"""Host-side image+caption datasets and their batch streams.

Counterpart of the JAX package's `data/loader.py`: `host_shard_order`,
`random_resized_crop`, `ImageFolderDataset` (captions from a sibling
`<stem>.txt`, a class-name JSON, the shipped ImageNet wnid map or the
parent directory's name), `Cub2011`, `MnistDataset`, `TextImageDataset`
(the folder-keyed tokenize / crop / batch stream, with a seeded fallback
for unreadable images) and `TokenDataset` (the `precompute_tokens`
artifact). Batches are numpy: {"text": [B, T] int32, "images":
[B, H, W, 3] float32 in [0, 1], "captions": [B] str}, or "image_tokens"
in place of "images" for `TokenDataset`.

The reference decodes and resizes through PIL, which the card's machine
lacks. Here:

* `decode_image`: PNG through the port's own zlib reader
  (`utils/images.py:decode_png`, 8-bit gray / RGB / RGBA); other formats,
  and PNG variants that reader does not take, through PIL where it is
  installed, and where it is not they raise, naming the format.
* `random_resized_crop` draws its box with the reference's numpy draws,
  so the boxes are identical, and resizes with
  `torch.nn.functional.interpolate(mode="bilinear", antialias=True)` (the
  filter PIL's bilinear resize applies), rounded half up to uint8 as PIL
  rounds. PIL also rounds between its horizontal and vertical passes, so
  a pixel may differ from PIL's by one step of 1/255.
* `Cub2011` reads its four index files with the standard library (the
  reference uses pandas).
"""

from __future__ import annotations

import io
import json
import re
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dalle_pytorch_tpu_torch.utils.images import decode_png

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

# ImageNet synset directory names, e.g. n01440764
_WNID_RE = re.compile(r"n\d{8}")
_IMAGENET_MAP: Optional[Dict[str, str]] = None

DIGIT_WORDS = (
    "zero", "one", "two", "three", "four",
    "five", "six", "seven", "eight", "nine",
)


def _imagenet_class_map() -> Dict[str, str]:
    """The shipped {wnid: class name} map, loaded at first use."""
    global _IMAGENET_MAP
    if _IMAGENET_MAP is None:
        path = Path(__file__).parent / "imagenet_classes.json"
        _IMAGENET_MAP = json.loads(path.read_text()) if path.exists() else {}
    return _IMAGENET_MAP


def host_shard_order(order: np.ndarray, shard: Tuple[int, int]) -> np.ndarray:
    """Process i of n takes every n-th index of `order`, after trimming it
    to a multiple of n, so that every process yields as many batches."""
    i, n = shard
    if n <= 1:
        return order
    usable = (len(order) // n) * n
    return order[:usable][i::n]


def _image_format(data: bytes) -> str:
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    return "unknown"


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """Image file bytes -> uint8 [H, W, 3] RGB (gray repeated, alpha
    dropped, as PIL's `convert("RGB")`)."""
    fmt = _image_format(data)
    if fmt == "PNG":
        try:
            img = decode_png(data, name)
        except ValueError:
            img = None  # a PNG variant the zlib reader does not take
        if img is not None:
            return np.ascontiguousarray(np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3])
    try:
        from PIL import Image
    except ImportError as exc:
        raise ValueError(
            f"{name}: decoding a {fmt} image needs PIL, which is not installed; "
            "the port reads 8-bit gray / RGB / RGBA PNG without it"
        ) from exc
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _load_image(path: Path) -> np.ndarray:
    return decode_image(Path(path).read_bytes(), str(path))


def resize_bilinear(img: np.ndarray, out_size: int) -> np.ndarray:
    """uint8 [h, w, C] -> float32 [out_size, out_size, C] in [0, 1]:
    antialiased bilinear, rounded half up to uint8 steps."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(out_size, out_size), mode="bilinear", align_corners=False,
                      antialias=True)
    y = torch.floor(y + 0.5).clamp_(0, 255)
    return (y[0].permute(1, 2, 0).numpy() / 255.0).astype(np.float32)


def random_resized_crop(
    img: np.ndarray,
    out_size: int,
    rng: np.random.RandomState,
    scale: Tuple[float, float] = (0.75, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> np.ndarray:
    """Area-scaled random crop (the reference's draws), resized to
    out_size; [0, 1] float32 output."""
    return resize_bilinear(_crop(img, rng, scale, ratio), out_size)


def _crop(img, rng, scale, ratio):
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            x = rng.randint(0, w - cw + 1)
            y = rng.randint(0, h - ch + 1)
            return img[y : y + ch, x : x + cw]
    side = min(h, w)  # central fallback
    y, x = (h - side) // 2, (w - side) // 2
    return img[y : y + side, x : x + side]


# ------------------------------------------------------------------ datasets


class _Dataset:
    """Minimal protocol: __len__ + get(i) -> (caption, uint8 image array)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> Tuple[str, np.ndarray]:
        raise NotImplementedError


class ImageFolderDataset(_Dataset):
    """Generic folder tree; caption = sibling .txt file, or the parent
    directory's name (mapped and cleaned)."""

    def __init__(
        self,
        folder: str,
        class_name_json: Optional[str] = None,
        prefer_txt_captions: bool = True,
    ):
        self.root = Path(folder)
        self.paths: List[Path] = sorted(
            p for p in self.root.rglob("*") if p.suffix.lower() in IMAGE_EXTS
        )
        if not self.paths:
            raise ValueError(f"no images found under {folder}")
        self.class_map: Dict[str, str] = {}
        if class_name_json:
            with open(class_name_json) as f:
                self.class_map = json.load(f)
        self.prefer_txt = prefer_txt_captions

    def __len__(self) -> int:
        return len(self.paths)

    def _caption(self, path: Path) -> str:
        if self.prefer_txt:
            txt = path.with_suffix(".txt")
            if txt.exists():
                return txt.read_text().strip()
        key = path.parent.name
        if key in self.class_map:
            return str(self.class_map[key])
        if _WNID_RE.fullmatch(key):
            name = _imagenet_class_map().get(key)
            if name:
                return name
        return key.replace("_", " ").replace("-", " ").strip()

    def get(self, i: int) -> Tuple[str, np.ndarray]:
        path = self.paths[i]
        return self._caption(path), _load_image(path)


def _table(path: Path) -> List[List[str]]:
    """The space-separated rows of a CUB-200 index file."""
    return [line.split(" ", 1) for line in path.read_text().splitlines() if line.strip()]


class Cub2011(_Dataset):
    """CUB-200-2011 from the standard extracted layout: images.txt,
    image_class_labels.txt, train_test_split.txt and classes.txt;
    captions are class names ("001.Black_footed_Albatross" -> "black
    footed albatross"). No download."""

    def __init__(self, root: str, train: bool = True):
        self.root = Path(root)
        base = self.root / "CUB_200_2011"
        if not base.exists():
            base = self.root
        labels = {i: int(t) for i, t in _table(base / "image_class_labels.txt")}
        split = {i: int(t) for i, t in _table(base / "train_test_split.txt")}
        want = 1 if train else 0
        self.rows = [
            (path.strip(), labels[i]) for i, path in _table(base / "images.txt")
            if i in labels and split.get(i) == want
        ]
        self.class_names = {int(c): name.strip() for c, name in _table(base / "classes.txt")}
        self.images_dir = base / "images"
        missing = [p for p, _ in self.rows[:16] if not (self.images_dir / p).exists()]
        if missing:
            raise FileNotFoundError(f"CUB-200 integrity check failed; missing {missing[:3]}")

    def __len__(self) -> int:
        return len(self.rows)

    def get(self, i: int) -> Tuple[str, np.ndarray]:
        path, target = self.rows[i]
        name = self.class_names[target]
        caption = name.split(".", 1)[-1].replace("_", " ").lower()
        return caption, _load_image(self.images_dir / path)


class MnistDataset(_Dataset):
    """MNIST from raw IDX files; captions are digit words."""

    def __init__(self, root: str, train: bool = True):
        base = Path(root)
        stem = "train" if train else "t10k"
        img_path = self._find(base, f"{stem}-images-idx3-ubyte")
        lbl_path = self._find(base, f"{stem}-labels-idx1-ubyte")
        with open(img_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad MNIST image magic {magic}")
            self.images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with open(lbl_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad MNIST label magic {magic}")
            self.labels = np.frombuffer(f.read(), np.uint8)

    @staticmethod
    def _find(base: Path, name: str) -> Path:
        for cand in (base / name, base / "MNIST" / "raw" / name):
            if cand.exists():
                return cand
        raise FileNotFoundError(f"{name} not found under {base}")

    def __len__(self) -> int:
        return len(self.images)

    def get(self, i: int) -> Tuple[str, np.ndarray]:
        img = np.repeat(self.images[i][..., None], 3, axis=-1)
        return DIGIT_WORDS[int(self.labels[i])], img


# ------------------------------------------------------------------ pipeline


class TextImageDataset:
    """Folder-keyed dataset ("cub200", "mnist" or an image folder) and its
    tokenize / crop / batch stream."""

    def __init__(
        self,
        folder: str,
        text_len: int = 256,
        image_size: int = 128,
        truncate_captions: bool = False,
        resize_ratio: float = 0.75,
        tokenizer=None,
        train: bool = True,
        class_name_json: Optional[str] = None,
        seed: int = 0,
    ):
        name = Path(folder).name.lower()
        if name == "cub200":
            self.dataset: _Dataset = Cub2011(folder, train=train)
        elif name == "mnist":
            self.dataset = MnistDataset(folder, train=train)
        else:
            self.dataset = ImageFolderDataset(folder, class_name_json)
        if tokenizer is None:
            from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer

            tokenizer = ByteTokenizer()
        self.tokenizer = tokenizer
        self.text_len = text_len
        self.image_size = image_size
        self.truncate_captions = truncate_captions
        self.resize_ratio = resize_ratio
        self.rng = np.random.RandomState(seed)
        # captions are the same every epoch (only the crop is random):
        # tokenize each once
        self._token_cache: dict = {}

    def __len__(self) -> int:
        return len(self.dataset)

    def _sample(self, i: int) -> Tuple[str, np.ndarray]:
        """Fetch, replacing an unreadable sample by a seeded random one."""
        for _ in range(8):
            try:
                return self.dataset.get(i)
            except Exception:
                i = int(self.rng.randint(0, len(self.dataset)))
        raise RuntimeError("too many corrupt samples in a row")

    def item(self, i: int) -> Tuple[np.ndarray, np.ndarray, str]:
        caption, img = self._sample(i)
        text = self._token_cache.get(caption)
        if text is None:
            text = self.tokenizer.tokenize(
                caption, self.text_len, truncate_text=self.truncate_captions
            )[0]
            if len(self._token_cache) < 500_000:
                self._token_cache[caption] = text
        img = random_resized_crop(
            img, self.image_size, self.rng, scale=(self.resize_ratio, 1.0)
        )
        return text, img, caption

    def batches(
        self,
        batch_size: int,
        shuffle_seed: Optional[int] = None,
        shard: Tuple[int, int] = (0, 1),
        drop_last: bool = True,
        start_batch: int = 0,
    ) -> Iterator[dict]:
        """{"text", "images", "captions"} batches; `start_batch` skips that
        many batches by index (a mid-epoch resume reads none of them)."""
        order = np.arange(len(self.dataset))
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(order)
        order = host_shard_order(order, shard)
        for start in range(start_batch * batch_size, len(order), batch_size):
            sel = order[start : start + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            texts, images, caps = zip(*(self.item(int(i)) for i in sel))
            yield {
                "text": np.stack(texts),
                "images": np.stack(images),
                "captions": list(caps),
            }


class TokenDataset:
    """The `precompute_tokens` artifact: raw captions (tokenized here, by
    the run's tokenizer), int32 image tokens and the VAE's geometry."""

    def __init__(self, npz_path, tokenizer, text_len: int):
        with np.load(npz_path, allow_pickle=False) as data:
            self.captions = [str(c) for c in data["captions"]]
            self.image_tokens = np.asarray(data["image_tokens"], np.int32)
            self.num_tokens = int(data["num_tokens"])
            self.image_size = int(data["image_size"])
            self.num_layers = int(data["num_layers"])
            self.vae_class_name = str(data["vae_class_name"])
        self.tokenizer = tokenizer
        self.text_len = text_len
        if len(self.captions) != self.image_tokens.shape[0]:
            raise ValueError(f"{npz_path}: {len(self.captions)} captions for "
                             f"{self.image_tokens.shape[0]} token rows")

    def __len__(self) -> int:
        return len(self.captions)

    def batches(
        self,
        batch_size: int,
        shuffle_seed: Optional[int] = None,
        shard: Tuple[int, int] = (0, 1),
        drop_last: bool = True,
        start_batch: int = 0,
    ) -> Iterator[dict]:
        order = np.arange(len(self))
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(order)
        order = host_shard_order(order, shard)
        for start in range(start_batch * batch_size, len(order), batch_size):
            sel = order[start : start + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            caps = [self.captions[i] for i in sel]
            yield {
                "text": self.tokenizer.tokenize(
                    caps, self.text_len, truncate_text=True
                ),
                "image_tokens": self.image_tokens[sel],
                "captions": caps,
            }
