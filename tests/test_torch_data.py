"""The port's datasets, crops and prefetcher vs the JAX package's.

Each package uses its own byte tokenizer (the same ids). Held:

* `RainbowDataset`: images bit-identical and captions equal, also past
  the 9216 combos (the jittered cycle), and its `batches` (shuffle seed,
  process shard, start batch) identical, images bit for bit.
* A PNG folder written by the port's `utils/images.py` (class
  directories, sibling captions, gray and RGBA files): batch order, text
  ids, captions and shapes identical; pixels within 1/255 of the JAX
  package's PIL path (the port resizes with torch's antialiased
  bilinear, PIL rounds between its two passes), plus 1e-6 for float32.
* `random_resized_crop`: the same numpy draws (the generators' states
  equal after every call, the central fallback included), so the same
  boxes; pixels within 1/255 + 1e-6 of PIL's, down- and upscaling.
* `TokenDataset` batches identical; a tar shard's batches: order, text
  ids and captions identical, pixels within 1/255 + 1e-6; the shard
  patterns expand alike.
* `decode_image` without PIL: PNG decodes as PIL's `convert("RGB")`
  does; another format raises, naming it.
* `Prefetcher`: order, early close, error propagation and
  `wait_fraction` in [0, 1]; `host_tensors` / `to_device` round-trip.
"""

import io
import sys
import tarfile

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.data import loader as jloader
from dalle_pytorch_tpu.data import prefetch as jprefetch
from dalle_pytorch_tpu.data import rainbow as jrainbow
from dalle_pytorch_tpu.data import webdataset as jwds
from dalle_pytorch_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from dalle_pytorch_tpu_torch.data import loader as ploader
from dalle_pytorch_tpu_torch.data import prefetch as pprefetch
from dalle_pytorch_tpu_torch.data import rainbow as prainbow
from dalle_pytorch_tpu_torch.data import webdataset as pwds
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.utils.images import encode_png, write_png

PIXEL_TOL = 1 / 255 + 1e-6


def _same_batches(ref, ours, pixel_tol=0.0):
    ref, ours = list(ref), list(ours)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ref, ours):
        assert sorted(a) == sorted(b)
        assert a["captions"] == b["captions"]
        np.testing.assert_array_equal(b["text"], a["text"])
        assert b["text"].dtype == a["text"].dtype
        for key in ("images", "image_tokens"):
            if key in a:
                assert b[key].shape == a[key].shape and b[key].dtype == a[key].dtype
                if pixel_tol:
                    assert np.abs(b[key] - a[key]).max() <= pixel_tol
                else:
                    np.testing.assert_array_equal(b[key], a[key])


@pytest.mark.parametrize("n, size", [(40, 32), (9230, 16)])
def test_rainbow_items_are_bit_identical(n, size):
    ref = jrainbow.RainbowDataset(num_samples=n, image_size=size, seed=3)
    ours = prainbow.RainbowDataset(num_samples=n, image_size=size, seed=3)
    assert len(ours) == len(ref) and ours.unique == ref.unique
    for i in list(range(12)) + [n - 1, n - 7]:
        assert ours.caption(i) == ref.caption(i)
        img = ours.image(i)
        assert img.dtype == np.float32 and np.array_equal(img, ref.image(i))


@pytest.mark.parametrize("shuffle_seed, shard, start", [(None, (0, 1), 0), (5, (0, 1), 2),
                                                        (7, (1, 2), 1), (7, (0, 3), 0)])
def test_rainbow_batches_are_identical(shuffle_seed, shard, start):
    ref = jrainbow.RainbowDataset(num_samples=30, image_size=32)
    ours = prainbow.RainbowDataset(num_samples=30, image_size=32)
    kw = dict(shuffle_seed=shuffle_seed, shard=shard, start_batch=start)
    _same_batches(ref.batches(4, JByteTokenizer(), 12, **kw), ours.batches(4, ByteTokenizer(), 12, **kw))


def _png_folder(root, seed=0):
    """Class directories of random PNGs (RGB, gray, RGBA) of several sizes,
    some with a sibling caption file."""
    rng = np.random.RandomState(seed)
    shapes = [(40, 40), (37, 52), (64, 30), (20, 20), (33, 48)]
    for k, cls in enumerate(("red_fox", "blue-jay", "n01440764", "cat")):
        d = root / cls
        d.mkdir(parents=True)
        for j in range(3):
            h, w = shapes[(k + j) % len(shapes)]
            c = (3, 1, 4)[(k + j) % 3]
            write_png(d / f"img{j}.png", rng.randint(0, 256, (h, w, c)).astype(np.uint8))
            if j == 1:
                (d / f"img{j}.txt").write_text(f"  a {cls} number {j}  \n")
    return root


@pytest.mark.parametrize("shuffle_seed, shard", [(None, (0, 1)), (3, (0, 1)), (4, (1, 2))])
def test_png_folder_batches_match_the_pil_path(tmp_path, shuffle_seed, shard):
    folder = _png_folder(tmp_path / "imgs")
    kw = dict(text_len=16, image_size=24, truncate_captions=True, resize_ratio=0.6, seed=9)
    ref = jloader.TextImageDataset(str(folder), tokenizer=JByteTokenizer(), **kw)
    ours = ploader.TextImageDataset(str(folder), tokenizer=ByteTokenizer(), **kw)
    assert len(ours) == len(ref) == 12
    bkw = dict(shuffle_seed=shuffle_seed, shard=shard, drop_last=False)
    _same_batches(ref.batches(3, **bkw), ours.batches(3, **bkw), PIXEL_TOL)
    caps = {ours.dataset._caption(p) for p in ours.dataset.paths}
    assert "a red_fox number 1" in caps and "blue jay" in caps and "tench" in caps


@pytest.mark.parametrize("h, w, out, scale", [(64, 48, 32, (0.3, 1.0)), (20, 25, 40, (0.5, 1.0)),
                                              (100, 100, 7, (0.08, 1.0)), (4, 200, 16, (0.99, 1.0)),
                                              (33, 33, 33, (1.0, 1.0))])
def test_crop_draws_and_pixels_match(h, w, out, scale):
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    r_ref, r_ours = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(5):
        a = jloader.random_resized_crop(img, out, r_ref, scale=scale)
        b = ploader.random_resized_crop(img, out, r_ours, scale=scale)
        assert b.shape == a.shape == (out, out, 3) and b.dtype == np.float32
        assert np.abs(b - a).max() <= PIXEL_TOL
        sa, sb = r_ref.get_state(), r_ours.get_state()
        assert sa[2] == sb[2] and np.array_equal(sa[1], sb[1])  # the same draws


def test_token_dataset_batches_are_identical(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "tokens.npz"
    np.savez_compressed(
        path, captions=np.array([f"caption {i} " + "x" * i for i in range(11)]),
        image_tokens=rng.randint(0, 64, (11, 16)).astype(np.int32), num_tokens=64,
        image_size=32, num_layers=3, vae_class_name="DiscreteVAE",
    )
    ref = jloader.TokenDataset(str(path), JByteTokenizer(), 8)
    ours = ploader.TokenDataset(str(path), ByteTokenizer(), 8)
    assert (ours.num_tokens, ours.image_size, ours.num_layers, ours.vae_class_name) == (
        ref.num_tokens, ref.image_size, ref.num_layers, ref.vae_class_name)
    for kw in (dict(), dict(shuffle_seed=2, start_batch=1), dict(shuffle_seed=1, shard=(1, 2),
                                                                drop_last=False)):
        _same_batches(ref.batches(3, **kw), ours.batches(3, **kw))


def _tar_shard(path, seed=0):
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(9):
            members = {"txt": f"sample {i}".encode()}
            if i != 4:  # one sample without an image: filtered
                members["png"] = encode_png(rng.randint(0, 256, (30 + i, 28, 3)).astype(np.uint8))
            for ext, data in members.items():
                info = tarfile.TarInfo(f"shard/{i:04d}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("shuffle_seed, start", [(None, 0), (3, 1)])
def test_tar_shard_batches_match(tmp_path, shuffle_seed, start):
    _tar_shard(tmp_path / "a-0000.tar", 0)
    _tar_shard(tmp_path / "a-0001.tar", 1)
    url = str(tmp_path / "a-{0000..0001}.tar")
    assert pwds.expand_shards(url) == jwds.expand_shards(url)
    assert pwds.expand_shards(str(tmp_path)) == jwds.expand_shards(str(tmp_path))
    kw = dict(image_key="png", text_len=12, image_size=16, shuffle_buffer=5, seed=2)
    ref = jwds.TarImageTextDataset(url, tokenizer=JByteTokenizer(), **kw)
    ours = pwds.TarImageTextDataset(url, tokenizer=ByteTokenizer(), **kw)
    bkw = dict(shuffle_seed=shuffle_seed, start_batch=start)
    _same_batches(ref.batches(3, **bkw), ours.batches(3, **bkw), PIXEL_TOL)


def test_decode_image_without_pil(monkeypatch):
    from PIL import Image

    rng = np.random.RandomState(1)
    pngs = {c: rng.randint(0, 256, (5, 7, c)).astype(np.uint8) for c in (1, 3, 4)}
    expect = {}
    for c, px in pngs.items():
        with Image.open(io.BytesIO(encode_png(px))) as im:
            expect[c] = np.asarray(im.convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(pngs[3]).save(buf, format="JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for c, px in pngs.items():
        got = ploader.decode_image(encode_png(px))
        assert got.shape == (5, 7, 3) and np.array_equal(got, expect[c])
    with pytest.raises(ValueError, match="JPEG"):
        ploader.decode_image(buf.getvalue(), "x.jpg")


def test_prefetcher_order_close_errors_and_wait_fraction():
    for pkg in (pprefetch, jprefetch):
        got = list(pkg.Prefetcher(range(20), transform=lambda x: x * 2, depth=3))
        assert got == [2 * i for i in range(20)]
    p = pprefetch.Prefetcher(iter(range(1000)), depth=2)
    assert [next(p) for _ in range(5)] == list(range(5))
    p.close()
    assert not p._thread.is_alive()
    assert 0.0 <= p.wait_fraction <= 1.0

    def boom():
        yield 1
        raise RuntimeError("bad batch")

    p = pprefetch.Prefetcher(boom())
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="bad batch"):
        next(p)

    arrays = {"text": np.arange(6, dtype=np.int32).reshape(2, 3), "images": np.ones((2, 2, 2, 3), np.float32)}
    host = pprefetch.host_tensors(arrays, pin=False)
    dev = pprefetch.to_device(host, torch.device("cpu"))
    for k, v in arrays.items():
        assert dev[k].dtype == torch.from_numpy(v).dtype and np.array_equal(dev[k].numpy(), v)
