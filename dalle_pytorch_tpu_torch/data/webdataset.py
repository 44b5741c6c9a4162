"""Streaming tar-shard dataset (WebDataset-style).

Counterpart of the JAX package's `data/webdataset.py`, copied: samples
are `key.jpg` + `key.txt` pairs (any of the image and text column names)
inside tar shards, given as one tar, a brace pattern
(`shard-{0000..0042}.tar`, `expand_shards`), a directory of tars, or a
`pipe:` command; members are grouped by key in stream order; samples
missing a column, and images that do not decode, are skipped with a
line on stdout. Process i of n reads every n-th shard; with a shuffle
seed the shard order is permuted and raw samples pass a shuffle buffer.
Images decode through `data/loader.py:decode_image` (PNG without PIL)
and are cropped by `random_resized_crop`, the loader's.
"""

from __future__ import annotations

import re
import subprocess
import tarfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dalle_pytorch_tpu_torch.data.loader import decode_image, random_resized_crop

IMAGE_KEYS = ("jpg", "jpeg", "png", "img", "image")
TEXT_KEYS = ("txt", "text", "cap", "caption")


def expand_shards(url: str) -> List[str]:
    """Expand `{0000..0099}` brace patterns / directories into shard lists."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", url)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        return [
            url[: m.start()] + str(i).zfill(width) + url[m.end() :]
            for i in range(int(lo), int(hi) + 1)
        ]
    p = Path(url)
    if p.is_dir():
        return [str(t) for t in sorted(p.glob("*.tar"))]
    return [url]


def _open_stream(url: str):
    """Returns (fileobj, proc_or_None)."""
    if url.startswith("pipe:"):
        proc = subprocess.Popen(
            url[len("pipe:") :], shell=True, stdout=subprocess.PIPE
        )
        return proc.stdout, proc
    return open(url, "rb"), None


def _iter_tar_samples(url: str) -> Iterator[dict]:
    """Group tar members by sample key ('dir/stem') preserving order."""
    stream, proc = _open_stream(url)
    try:
        with tarfile.open(fileobj=stream, mode="r|*") as tar:
            current_key, fields = None, {}
            for member in tar:
                if not member.isfile():
                    continue
                name = member.name
                stem, _, ext = name.rpartition(".")
                if current_key is not None and stem != current_key and fields:
                    yield fields
                    fields = {}
                current_key = stem
                data = tar.extractfile(member)
                if data is not None:
                    fields[ext.lower()] = data.read()
            if fields:
                yield fields
    finally:
        stream.close()
        if proc is not None:
            ret = proc.wait()
            if ret != 0:
                raise RuntimeError(
                    f"pipe command for shard {url!r} exited with status {ret} "
                    "— stream may be truncated"
                )


class TarImageTextDataset:
    """Iterable tar-shard dataset -> host-sharded numpy batches."""

    def __init__(
        self,
        urls: str,
        image_key: str = "jpg",
        text_key: str = "txt",
        text_len: int = 256,
        image_size: int = 128,
        truncate_captions: bool = True,
        resize_ratio: float = 0.75,
        tokenizer=None,
        seed: int = 0,
        shuffle_buffer: int = 1000,
    ):
        self.shards = expand_shards(urls)
        if not self.shards:
            raise ValueError(f"no shards matched {urls}")
        self.image_keys = (image_key,) + IMAGE_KEYS
        self.text_keys = (text_key,) + TEXT_KEYS
        if tokenizer is None:
            from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer

            tokenizer = ByteTokenizer()
        self.tokenizer = tokenizer
        self.text_len = text_len
        self.image_size = image_size
        self.truncate = truncate_captions
        self.resize_ratio = resize_ratio
        self.rng = np.random.RandomState(seed)
        self.shuffle_buffer = shuffle_buffer

    def _decode(self, sample: dict) -> Optional[Tuple[str, np.ndarray]]:
        img_bytes = next(
            (sample[k] for k in self.image_keys if k in sample), None
        )
        txt_bytes = next(
            (sample[k] for k in self.text_keys if k in sample), None
        )
        if img_bytes is None or txt_bytes is None:
            return None  # both columns required
        try:
            img = decode_image(img_bytes, "tar sample")
            return txt_bytes.decode("utf-8", errors="replace").strip(), img
        except Exception as e:  # skip and go on
            print(f"[wds] skipping undecodable sample: {e}")
            return None

    def samples(
        self,
        shard: Tuple[int, int] = (0, 1),
        shuffle_seed: Optional[int] = None,
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Shard-level host split: host i reads every n-th tar shard.

        With `shuffle_seed`, the per-host shard order is permuted and
        samples pass through a reservoir-style shuffle buffer — the
        streaming equivalent of a `wds.WebDataset` shuffle stage.
        Different seeds (e.g. seed+epoch) give a fresh order every epoch.
        """
        if shard[1] > 1 and len(self.shards) < shard[1]:
            raise ValueError(
                f"{len(self.shards)} tar shards cannot be split across "
                f"{shard[1]} hosts — provide at least one shard per host"
            )
        my_shards = self.shards[shard[0] :: shard[1]]
        rng = None
        if shuffle_seed is not None:
            rng = np.random.RandomState(shuffle_seed)
            my_shards = [my_shards[i] for i in rng.permutation(len(my_shards))]

        def raw_stream() -> Iterator[dict]:
            for url in my_shards:
                yield from _iter_tar_samples(url)

        def shuffled_raw() -> Iterator[dict]:
            # Buffer RAW tar samples (compressed bytes, ~100KB each), not
            # decoded arrays — decoding before the 1000-slot buffer would
            # hold ~GBs of pixels per host. Decode happens on yield, with
            # failures filtered after the shuffle stage, exactly like the
            # reference's shuffle->decode(warn_and_continue) pipeline order.
            if rng is None or self.shuffle_buffer <= 1:
                yield from raw_stream()
                return
            buf: List[dict] = []
            for item in raw_stream():
                buf.append(item)
                if len(buf) >= self.shuffle_buffer:
                    j = rng.randint(len(buf))
                    buf[j], buf[-1] = buf[-1], buf[j]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        for raw in shuffled_raw():
            decoded = self._decode(raw)
            if decoded is not None:
                yield decoded

    def batches(
        self,
        batch_size: int,
        shuffle_seed: Optional[int] = None,
        shard: Tuple[int, int] = (0, 1),
        start_batch: int = 0,
    ) -> Iterator[dict]:
        """`start_batch` skips already-consumed batches on resume. For a
        streaming tar source the skip must still read+decode the stream to
        keep the sample order identical — unavoidable without an index."""
        stream = self.samples(shard, shuffle_seed=shuffle_seed)
        if start_batch:
            import itertools

            stream = itertools.islice(stream, start_batch * batch_size, None)
        texts, images, captions = [], [], []
        for caption, img in stream:
            texts.append(
                self.tokenizer.tokenize(caption, self.text_len, self.truncate)[0]
            )
            images.append(
                random_resized_crop(
                    img, self.image_size, self.rng, scale=(self.resize_ratio, 1.0)
                )
            )
            captions.append(caption)
            if len(texts) == batch_size:
                yield {
                    "text": np.stack(texts),
                    "images": np.stack(images),
                    "captions": captions,
                }
                texts, images, captions = [], [], []
