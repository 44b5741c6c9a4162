"""The port's streamed generation (CPU): the SSE codec and event
channels against the JAX package's, previews against the JAX engine's,
and stream events from a real tiny engine.

* `encode_sse` gives the JAX package's bytes; `SSEParser`,
  `RequestStream` and `StreamRegistry` pass the JAX package's non-HTTP
  streaming cases (`tests/test_streaming.py`: the codec, the progress
  high water, preview cadence, one terminal, the bounded ring, reader
  generations, the registry's bounds).
* `preview_fill_token` equals the JAX engine's and `preview_pixels`
  its pixels within 1e-5 (the same dVAE weights, float32).
* Through the `ContinuousBatcher`: progress events rise chunk by chunk,
  previews arrive every `preview_every` chunks as [n, H, W, 3] in [0,
  1], the future's tokens equal a non-streamed run's, and the batcher
  writes no terminal event (the stream's reader does, from the future:
  `tests/test_torch_server.py` holds the HTTP server's); a migrated
  stream's future carries the checkpoint its terminal event ships.
"""

import threading
import time

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving.engine import ContinuousEngine as JContinuousEngine
from dalle_pytorch_tpu.serving.streaming import encode_sse as j_encode_sse
from dalle_pytorch_tpu.training.metrics import MetricsRegistry as JMetricsRegistry
from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, PagedContinuousEngine, SampleSpec
from dalle_pytorch_tpu_torch.serving.migrate import MigratedError, decode_checkpoint
from dalle_pytorch_tpu_torch.serving.streaming import (
    TERMINAL_TYPES,
    RequestStream,
    SSEParser,
    StreamRegistry,
    encode_sse,
)
from test_torch_dalle import TINY, TINY_VAE, _dalle_pair, _text, _vae_pair
from test_torch_resume import _export, _hold_after

torch.set_num_threads(2)

IMG_SEQ = TINY["image_fmap_size"] ** 2
CHUNK = 2
N_CHUNKS = IMG_SEQ // CHUNK


# ----------------------------------------------------------- wire format


@pytest.mark.parametrize(
    "etype,data,seq",
    [("open", {"request_key": "k1", "cursor": 0}, None), ("progress", {"chunk": 3, "tokens": [1, 2]}, 7),
     ("result", {"b": 1.5, "a": None, "s": "x y"}, 0)],
)
def test_encode_sse_gives_the_reference_bytes(etype, data, seq):
    assert encode_sse(etype, data, seq=seq) == j_encode_sse(etype, data, seq=seq)


def test_sse_round_trip_including_split_chunks():
    frames = (
        encode_sse("open", {"request_key": "k1", "cursor": 0})
        + encode_sse("progress", {"chunk": 1, "tokens": 4}, seq=0)
        + b": keep-alive\n\n"
        + encode_sse("result", {"tokens": [[1, 2]]}, seq=1)
    )
    parser = SSEParser()
    events = []
    for i in range(0, len(frames), 3):
        events.extend(parser.feed(frames[i : i + 3]))
    assert [e[0] for e in events] == ["open", "progress", "result"]
    assert events[0][2] is None
    assert events[1][1]["chunk"] == 1 and events[1][2] == 0
    assert events[2][2] == 1 and events[2][0] in TERMINAL_TYPES


def test_sse_non_json_data_degrades_to_raw():
    assert SSEParser().feed(b"event: weird\ndata: not json\n\n") == [("weird", {"raw": "not json"}, None)]


def test_progress_high_water_swallows_replays():
    s = RequestStream(key="k")
    assert s.progress(1, tokens=4) and s.progress(2, tokens=8)
    assert not s.progress(1, tokens=4) and not s.progress(2, tokens=8)
    assert s.progress(3, tokens=12)
    events, _ = s.next_events(0, timeout=0.0)
    assert [d["chunk"] for _s, t, d in events if t == "progress"] == [1, 2, 3]


def test_preview_cadence_and_dedup():
    s = RequestStream(key="k")
    assert not s.preview_due(0, 2) and not s.preview_due(1, 2) and s.preview_due(2, 2)
    assert s.preview(2, rows=[0])
    assert not s.preview_due(2, 2) and not s.preview(2, rows=[0])
    assert not s.preview_due(3, 2) and s.preview_due(4, 2) and not s.preview_due(4, 0)
    assert s.previews_sent == 1


def test_terminal_wins_once_and_seals_the_stream():
    s = RequestStream(key="k")
    assert s.finish("result", tokens=[[1]])
    assert not s.finish("error", status=500) and not s.emit("progress", chunk=9)
    assert s.finished
    events, drained = s.next_events(0, timeout=0.0)
    assert [t for _s, t, _d in events] == ["result"] and not drained
    events, drained = s.next_events(s.end_seq(), timeout=0.0)
    assert events == [] and drained


def test_wake_ends_the_readers_wait():
    s = RequestStream(key="k")
    s.wake()  # before the reader waits: sticky
    t0 = time.monotonic()
    assert s.next_events(0, timeout=5.0) == ([], False)
    waker = threading.Timer(0.05, s.wake)
    waker.start()
    assert s.next_events(0, timeout=5.0) == ([], False)
    waker.join(5)
    assert time.monotonic() - t0 < 2.0
    assert s.next_events(0, timeout=0.01) == ([], False)  # a wake is seen once


def test_ring_is_bounded_with_absolute_seqs():
    s = RequestStream(key="k", max_events=8)
    for c in range(1, 21):
        s.progress(c)
    events, _ = s.next_events(0, timeout=0.0)
    assert [seq for seq, _t, _d in events] == list(range(12, 20))
    assert [d["chunk"] for _s, _t, d in events] == list(range(13, 21))
    assert s.detail()["dropped"] == 12


def test_attach_generations_supersede_and_orphan():
    s = RequestStream(key="k")
    g1 = s.attach(mark_reattach=False)
    assert s.current(g1) and s.reattaches == 0
    g2 = s.attach()
    assert s.reattaches == 1 and not s.current(g1) and s.current(g2)
    assert not s.orphan(g1)
    assert s.orphan(g2) and s.orphaned
    g3 = s.attach()
    assert not s.orphaned and s.current(g3)


def test_registry_register_reattach_discard_and_gauge():
    seen = []
    reg = StreamRegistry(max_streams=4, gauge=seen.append)
    s = RequestStream(key="req-1")
    assert reg.register(s) and seen[-1] == 1
    assert reg.get("req-1") is s and reg.reattach("req-1") is s
    s.finish("result")
    assert reg.reattach("req-1") is None
    reg.discard(s)
    assert reg.get("req-1") is None and seen[-1] == 0


def test_registry_full_of_live_streams_rejects():
    reg = StreamRegistry(max_streams=2)
    a, b = RequestStream(key="a"), RequestStream(key="b")
    assert reg.register(a) and reg.register(b)
    assert not reg.register(RequestStream(key="c"))
    a.finish("result")
    c = RequestStream(key="c")
    assert reg.register(c) and reg.get("a") is None and reg.get("c") is c and reg.active() == 2


def test_registry_detail_shape():
    reg = StreamRegistry(max_streams=2)
    s = RequestStream(key="a")
    reg.register(s)
    s.progress(1)
    d = reg.detail()
    assert d["active"] == 1 and d["streams"][0]["key"] == "a"
    anon = RequestStream(key=None)
    assert reg.register(anon) and anon.key.startswith("anon-")


# -------------------------------------------------------------- previews


@pytest.fixture(scope="module")
def models():
    jm, variables, pm = _dalle_pair(seed=41, shift_tokens=True, rotary_emb=True)
    jv, vparams, pv = _vae_pair(seed=5)
    return jm, variables, pm, jv, vparams, pv


def test_previews_match_the_reference_engine(models):
    jm, variables, pm, jv, vparams, pv = models
    jeng = JContinuousEngine(
        jm, variables, vae=jv, vae_params=vparams["params"], max_batch=4, chunk_tokens=CHUNK,
        prefill_batch=2, registry=JMetricsRegistry(), preview_enabled=True,
    )
    peng = ContinuousEngine(pm, pv, max_batch=4, chunk_tokens=CHUNK, prefill_batch=2, device="cpu",
                            preview_enabled=True)
    assert peng.preview_fill_token() == jeng.preview_fill_token()
    rng = np.random.RandomState(9)
    toks = rng.randint(0, TINY_VAE["num_tokens"], (5, IMG_SEQ)).astype(np.int32)
    pos = np.asarray([0, 1, 7, IMG_SEQ - 1, IMG_SEQ], np.int32)  # 5 rows: two decode batches
    ours = peng.preview_pixels(toks, pos)
    ref = jeng.preview_pixels(toks, pos)
    assert ours.shape == (5, TINY_VAE["image_size"], TINY_VAE["image_size"], 3)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=0)
    # a complete row previews as its decoded image
    np.testing.assert_allclose(ours[4], peng.decode_pixels(toks[4:])[0], atol=1e-6, rtol=0)
    assert "preview" in peng.program_ladder()
    assert ContinuousEngine(pm, max_batch=4, device="cpu").preview_pixels(toks, pos) is None


# ------------------------------------------------------- engine streams


def _specs(n, seed=70):
    texts = _text(n, seed=seed)
    return [SampleSpec(texts[i], seed=seed + i, top_k=0.5) for i in range(n)]


def _events(stream):
    events, drained = stream.next_events(0, timeout=0.0)
    return [(t, d) for _s, t, d in events], drained


@pytest.mark.parametrize("paged", [False, True])
def test_stream_events_from_a_real_engine(models, paged):
    _, _, pm, _, _, pv = models
    cls = PagedContinuousEngine if paged else ContinuousEngine
    kw = dict(page_size=4) if paged else {}
    eng = cls(pm, pv, max_batch=2, chunk_tokens=CHUNK, prefill_batch=2, device="cpu", preview_enabled=True, **kw)
    eng.warmup()
    b = ContinuousBatcher(eng, preview_every=3)
    specs = _specs(2)
    try:
        plain, _ = b.submit(specs).future.result(60)
        stream = RequestStream(key="s1")
        req = b.submit(specs, request_key="s1", stream=stream)
        toks, pixels = req.future.result(60)
    finally:
        b.shutdown()
    np.testing.assert_array_equal(toks, plain)
    events, drained = _events(stream)
    progress = [d for t, d in events if t == "progress"]
    previews = [d for t, d in events if t == "preview"]
    terminal = [(t, d) for t, d in events if t in TERMINAL_TYPES]
    assert [d["chunk"] for d in progress] == list(range(1, N_CHUNKS + 1))
    assert [d["tokens"] for d in progress] == [2 * CHUNK * c for c in range(1, N_CHUNKS + 1)]
    assert all(d["total_tokens"] == 2 * IMG_SEQ and d["rows"] == 2 for d in progress)
    assert [d["chunk"] for d in previews] == [c for c in range(1, N_CHUNKS + 1) if c % 3 == 0]
    size = pv.image_size
    for d in previews:
        assert d["rows"] == [0, 1] and d["pixels"].shape == (2, size, size, 3)
        assert 0.0 <= d["pixels"].min() and d["pixels"].max() <= 1.0
    # the terminal event is the reader's, written from the resolved future
    assert terminal == [] and events[-1][0] == "progress"
    assert not stream.finished and not drained
    counts = {k: int(c.value) for k, c in b.registry.get("dalle_serving_stream_events_total").items()}
    assert counts == {"progress": N_CHUNKS, "preview": len(previews)}
    assert pixels.shape == (2, size, size, 3)
    if paged:
        assert eng.kv.leak_check() == []


def test_a_migrated_stream_ends_with_its_checkpoint(models):
    _, _, pm, _, _, pv = models
    eng = ContinuousEngine(pm, pv, max_batch=2, chunk_tokens=CHUNK, prefill_batch=2, device="cpu",
                           resume_enabled=True, preview_enabled=True)
    reached, gate = _hold_after(eng, 2)
    b = ContinuousBatcher(eng, preview_every=1)
    stream = RequestStream(key="m1")
    try:
        req = b.submit(_specs(1, seed=80), request_key="m1", stream=stream)
        assert reached.wait(30)
        cps = _export(b, gate)
    finally:
        b.shutdown()
    events, _ = _events(stream)
    assert [t for t, _ in events] == ["progress", "preview", "progress", "preview"]
    assert not stream.finished  # the reader ends it with the "migrated" event
    with pytest.raises(MigratedError) as err:
        req.future.result(0)
    cp = err.value.checkpoint
    assert cp.chunk_index == 2 and cp.request_key == "m1"
    back = decode_checkpoint(cp.encoded, b.checkpoint_fingerprint)  # encoded once, shipped as is
    np.testing.assert_array_equal(back.rows[0].tokens, cps[0].rows[0].tokens)
    assert back.rows[0].pos == 2 * CHUNK
