"""The port's continuous batching vs the JAX package's, and its own
decode-composition contract (CPU).

* Slot ops: the same admission schedule through JAX `prefill_into_slots`
  / `decode_image_chunk` / `release_slots` and the port's, greedy (keep
  one logit, so the packages' different noise sources cannot matter):
  K/V caches and token-shift rings of the admitted slots within 1e-5,
  pending logits within 1e-4, `img_pos` / `active` / tokens equal. Token
  identity is meaningful because every greedy step's top-2 image-logit
  gap in the JAX run is asserted to exceed 1e-3.
* Engines: greedy tokens of the port's `ContinuousEngine` equal the JAX
  `ContinuousEngine`'s under the same schedule; inside the port, sampled
  tokens equal the micro engine's alone, padded, mid-flight and after
  slot reuse (row i's noise depends on its seed and position only).
* `SlotAllocator`, the `ContinuousBatcher` (on a fake engine and a real
  one), `engine_from_checkpoint(mode="continuous")` on a JAX-written
  checkpoint, and the error probes.
"""

import copy
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import decode_image_chunk as j_chunk
from dalle_pytorch_tpu.models.dalle import init_slot_state as j_init_slot_state
from dalle_pytorch_tpu.models.dalle import prefill_into_slots as j_prefill
from dalle_pytorch_tpu.models.dalle import release_slots as j_release
from dalle_pytorch_tpu.serving.engine import ContinuousEngine as JContinuousEngine
from dalle_pytorch_tpu.serving.engine import SampleSpec as JSpec
from dalle_pytorch_tpu.training.config import TrainConfig
from dalle_pytorch_tpu.training.metrics import MetricsRegistry
from dalle_pytorch_tpu.training.pipeline import dvae_hparams, save_dalle_checkpoint
from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
from dalle_pytorch_tpu_torch.models.dalle import (
    decode_image_chunk,
    init_slot_state,
    prefill_into_slots,
    release_slots,
)
from dalle_pytorch_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    QueueFullError,
    ShuttingDownError,
)
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    GenerationEngine,
    PagedContinuousEngine,
    SampleSpec,
    SlotAllocator,
    engine_from_checkpoint,
)
from test_torch_dalle import TINY, _dalle_pair, _text, _vae_pair

torch.set_num_threads(2)

IMG_SEQ = TINY["image_fmap_size"] ** 2
MODEL = dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=True)
MIN_GAP = 1e-3


@pytest.fixture(scope="module")
def pair():
    return _dalle_pair(seed=17, **MODEL)


def _compare_slots(jstate, pstate, slots):
    for name, jl in jstate["cache"].items():
        pl = pstate["cache"][name]
        for key in ("k", "v"):
            np.testing.assert_allclose(
                pl["attn"][key][slots].numpy(), np.asarray(jl["attn"][key])[slots],
                atol=1e-5, rtol=0,
            )
        for key in ("shift_attn", "shift_ff"):
            np.testing.assert_allclose(
                pl[key][slots].numpy(), np.asarray(jl[key])[slots], atol=1e-5, rtol=0
            )
    np.testing.assert_allclose(
        pstate["row"][slots].numpy(), np.asarray(jstate["row"])[slots], atol=1e-4, rtol=0
    )
    for key in ("img_pos", "active", "img_tokens"):
        np.testing.assert_array_equal(pstate[key][slots].numpy(), np.asarray(jstate[key])[slots])
    np.testing.assert_array_equal(pstate["host"]["img_pos"], pstate["img_pos"].numpy())
    np.testing.assert_array_equal(pstate["host"]["active"], pstate["active"].numpy())


def _image_gap(row, total_text_tokens):
    img = np.sort(np.asarray(row)[:, total_text_tokens:], axis=-1)
    return img[:, -1] - img[:, -2]


def test_slot_ops_match_the_reference(pair):
    jm, variables, pm = pair
    texts = _text(3, seed=4)
    jstate = j_init_slot_state(jm, 4)
    pstate = init_slot_state(pm, 4)
    keep = [1, 1]

    def admit(slots, rows):
        nonlocal jstate
        padded = rows + [rows[0]] * (2 - len(rows))
        sl = slots + [slots[0]] * (2 - len(slots))
        seeds = [3 + s for s in sl]
        jstate = j_prefill(jm, variables, jstate, texts[padded], sl, seeds, [1.0, 1.0], keep)
        prefill_into_slots(pm, pstate, texts[padded], sl, seeds, [1.0, 1.0], keep)

    def chunk():
        nonlocal jstate
        live = np.asarray(jstate["active"]) & (np.asarray(jstate["img_pos"]) < IMG_SEQ)
        gaps = _image_gap(jstate["row"], jm.total_text_tokens)[live]
        assert gaps.size == 0 or gaps.min() >= MIN_GAP, f"greedy not meaningful: {gaps.min()}"
        jstate = j_chunk(jm, variables, jstate, 4)
        decode_image_chunk(pm, pstate, 4)

    admit([2, 0], [0, 1])
    _compare_slots(jstate, pstate, [0, 2])
    chunk()
    _compare_slots(jstate, pstate, [0, 2])
    admit([1], [2])  # mid-flight, a padded wave
    for _ in range(2):
        chunk()
    _compare_slots(jstate, pstate, [0, 1, 2])
    mask = np.array([False, False, True, False])
    jstate = j_release(jm, jstate, mask)
    release_slots(pstate, [2])
    for _ in range(3):
        chunk()
    _compare_slots(jstate, pstate, [0, 1, 2])
    assert (pstate["img_pos"][[0, 1]] == IMG_SEQ).all()


def _greedy(text_ids, seed):
    return dict(text_ids=text_ids, seed=seed, temperature=1.0, top_k=1.0)


def test_greedy_engine_tokens_match_the_reference(pair):
    jm, variables, pm = pair
    texts = _text(3, seed=8)
    jeng = JContinuousEngine(
        jm, variables, max_batch=4, chunk_tokens=4, prefill_batch=2, registry=MetricsRegistry()
    )
    peng = ContinuousEngine(pm, max_batch=4, chunk_tokens=4, prefill_batch=2, device="cpu")
    out = []
    for eng, spec in ((jeng, JSpec), (peng, SampleSpec)):
        a, b, c = (spec(**_greedy(t, s)) for t, s in zip(texts, (11, 12, 13)))
        eng.prefill_slots([(0, a), (1, b)])
        eng.step_chunk()
        eng.prefill_slot(3, c)
        for _ in range(8):
            pos, act = eng.step_chunk()
            if (pos[act] >= IMG_SEQ).all():
                break
        out.append(eng.harvest([0, 1, 3]))
        eng.release([0, 1, 3])
    np.testing.assert_array_equal(out[1], out[0])
    assert peng.stats.prefill_dispatches == 2 and peng.stats.prefills == 3


@pytest.fixture(scope="module")
def engines(pair):
    _, _, pm = pair
    micro = GenerationEngine(pm, batch_shapes=(1, 4), device="cpu")
    cont = ContinuousEngine(pm, max_batch=4, chunk_tokens=4, prefill_batch=2, device="cpu")
    return micro, cont


def _spec(seed, **kw):
    text = _text(1, seed=seed % 7)[0]
    return SampleSpec(text, seed=seed, **{"temperature": 1.0, "top_k": 0.5, **kw})


def _drain(cont):
    for _ in range(16):
        pos, act = cont.step_chunk()
        if (pos[act] >= IMG_SEQ).all():
            return pos, act
    raise AssertionError("decode never finished")


def test_alone_padded_and_mid_flight_give_the_micro_tokens(engines):
    micro, cont = engines
    alone, _ = micro.generate([_spec(55)])
    padded, _ = micro.generate([_spec(99), _spec(55), _spec(7)])
    np.testing.assert_array_equal(alone[0], padded[1])
    cont.prefill_slot(0, _spec(99))
    cont.step_chunk()  # slot 0 is mid-image
    cont.prefill_slots([(2, _spec(55)), (3, _spec(7))])  # admitted mid-flight
    _drain(cont)
    toks = cont.harvest([0, 2, 3])
    cont.release([0, 2, 3])
    np.testing.assert_array_equal(toks, padded)


def test_slot_reuse_leaks_no_state(engines):
    micro, cont = engines
    alone, _ = micro.generate([_spec(123, temperature=0.7)])
    cont.prefill_slot(1, _spec(5))
    _drain(cont)
    cont.release([1])
    cont.prefill_slot(1, _spec(123, temperature=0.7))
    _drain(cont)
    np.testing.assert_array_equal(cont.harvest([1])[0], alone[0])
    cont.release([1])


@pytest.mark.parametrize("kv_dtype,sparsity", [(None, "policy"), ("int8", "causal")])
def test_options_keep_the_composition_contract(pair, kv_dtype, sparsity):
    """With int8 KV or policy bitmaps, a row's tokens still depend on its
    own seed alone; policy bitmaps on full layers change no bit, and the
    option lives on the engine's copy of the model, not on the caller's."""
    _, _, pm = pair
    cont = ContinuousEngine(
        pm, max_batch=4, chunk_tokens=4, prefill_batch=4, device="cpu",
        kv_dtype=kv_dtype, decode_sparsity=sparsity,
    )
    assert pm.kv_dtype is None and pm.decode_sparse_block is None
    assert cont.model.kv_dtype == kv_dtype
    cont.prefill_slots([(0, _spec(31))])
    pos, act = _drain(cont)
    alone = cont.harvest([0])
    cont.release([0])
    cont.prefill_slots([(2, _spec(8)), (1, _spec(31))])
    _drain(cont)
    np.testing.assert_array_equal(cont.harvest([1]), alone)
    if sparsity == "policy":
        detail = cont.sparsity_detail()
        assert detail["mode"] == "policy" and detail["patterned_layers"] == 1
        assert detail["kv_tiles_read"] > 0
    else:
        assert cont.sparsity_detail() is None
        full = ContinuousEngine(pm, device="cpu").kv_bytes_per_slot()
        d = TINY["dim_head"]  # int8 values + an fp32 scale per position vs fp32 values
        assert cont.kv_bytes_per_slot() / full == (d + 4) / (4 * d)


def test_policy_skips_tiles_and_tracks_the_masked_decode(pair):
    """Small tiles (4 positions) so axial rows really skip: the sparse
    engine reads fewer tiles than the length skip would, and stays close
    to the dense pattern decode (the same model through the micro
    engine): not bit-identical, but most greedy tokens agree."""
    _, _, pm = pair
    pm_small = copy.copy(pm)  # the same weights, with a 4-position tile
    pm_small.decode_sparse_block = 4
    cont = ContinuousEngine(pm_small, max_batch=2, chunk_tokens=2, device="cpu", decode_sparsity="policy")
    micro = GenerationEngine(pm, batch_shapes=(2,), device="cpu")
    specs = [_spec(s, top_k=1.0) for s in (1, 2)]
    cont.prefill_slots(list(enumerate(specs)))
    _drain(cont)
    toks = cont.harvest([0, 1])
    ref, _ = micro.generate(specs)
    assert cont.stats.kv_tiles_skipped > 0
    assert (toks == ref).mean() >= 0.5


def test_slot_allocator():
    a = SlotAllocator(3)
    assert [a.alloc() for _ in range(3)] == [0, 1, 2]
    assert a.alloc() is None and a.n_free == 0 and a.n_active == 3
    a.free(1)
    a.free(0)
    assert a.alloc() == 0 and a.alloc() == 1  # lowest free slot first
    with pytest.raises(ValueError):
        a.free(7)
    with pytest.raises(ValueError):
        SlotAllocator(0)


class FakeEngine:
    """The slot surface: each chunk advances every active slot by `chunk`
    positions; a row's tokens carry its seed."""

    image_seq_len = 8
    max_batch = 4

    def __init__(self, chunk=4, prefill_batch=2, fail_chunks=False, gate=None):
        self.chunk, self.prefill_batch = chunk, prefill_batch
        self.fail_chunks, self.gate = fail_chunks, gate
        self.pos = np.zeros(self.max_batch, np.int64)
        self.active = np.zeros(self.max_batch, bool)
        self.seeds = np.zeros(self.max_batch, np.int64)
        self.waves = []

    def prefill_slots(self, assignments):
        assert 1 <= len(assignments) <= self.prefill_batch
        self.waves.append(sorted(s for s, _ in assignments))
        for slot, sp in assignments:
            self.pos[slot], self.active[slot], self.seeds[slot] = 0, True, sp.seed

    def step_chunk(self):
        if self.gate is not None:
            assert self.gate.wait(10.0)
        if self.fail_chunks:
            raise RuntimeError("the device fell over")
        self.pos[self.active & (self.pos < self.image_seq_len)] += self.chunk
        return self.pos.copy(), self.active.copy()

    def harvest(self, slots):
        return np.stack([np.full(self.image_seq_len, self.seeds[s], np.int32) for s in slots])

    def release(self, slots):
        for s in slots:
            self.active[s] = False

    def decode_pixels(self, tokens):
        return None


def _fake_spec(seed):
    return SampleSpec(np.zeros(8, np.int32), seed=seed)


def test_batcher_admits_whole_requests_in_waves_and_backfills():
    gate = threading.Event()
    eng = FakeEngine(chunk=2, gate=gate)
    b = ContinuousBatcher(eng)
    first = b.submit([_fake_spec(1), _fake_spec(2), _fake_spec(3)])
    time.sleep(0.05)  # the worker admits `first` and parks in its chunk
    wide = b.submit([_fake_spec(4), _fake_spec(5)])  # two rows, one slot free
    narrow = [b.submit([_fake_spec(s)]) for s in range(6, 12)]  # past max_batch
    gate.set()
    assert [int(t[0]) for t in first.future.result(10)[0]] == [1, 2, 3]
    assert [int(t[0]) for t in wide.future.result(10)[0]] == [4, 5]
    for s, r in zip(range(6, 12), narrow):
        toks, pixels = r.future.result(10)
        assert toks.shape == (1, 8) and int(toks[0, 0]) == s and pixels is None
        assert r.first_token_at is not None
    assert eng.waves[:2] == [[0, 1], [2]]  # a 3-row request in waves of 2
    assert all(len(w) <= 2 for w in eng.waves)
    assert b.admitted_rows == 11 and b.images == 11
    b.shutdown()


def test_batcher_rejects_what_it_cannot_queue():
    gate = threading.Event()
    b = ContinuousBatcher(FakeEngine(gate=gate), max_queue_rows=3)
    with pytest.raises(QueueFullError, match="slots"):
        b.submit([_fake_spec(i) for i in range(5)])
    b.submit([_fake_spec(0)])
    deadline = time.monotonic() + 10
    while b.inflight_rows < 1 and time.monotonic() < deadline:
        time.sleep(0.005)  # until admitted: the queue is empty again
    b.submit([_fake_spec(1), _fake_spec(2), _fake_spec(3)])
    with pytest.raises(QueueFullError, match="queue full"):
        b.submit([_fake_spec(4)])
    gate.set()
    b.shutdown()
    with pytest.raises(ShuttingDownError):
        b.submit([_fake_spec(5)])


def test_batcher_drains_on_shutdown():
    gate = threading.Event()
    b = ContinuousBatcher(FakeEngine(gate=gate))
    reqs = [b.submit([_fake_spec(i)]) for i in range(7)]
    time.sleep(0.05)
    gate.set()
    b.shutdown(drain=True)
    for i, r in enumerate(reqs):
        assert int(r.future.result(0.1)[0][0, 0]) == i
    assert not b._worker.is_alive()


def test_batcher_engine_error_fails_fast_and_keeps_serving():
    eng = FakeEngine(fail_chunks=True)
    b = ContinuousBatcher(eng)
    r = b.submit([_fake_spec(0), _fake_spec(1)])
    with pytest.raises(RuntimeError, match="fell over"):
        r.future.result(10)
    assert isinstance(b.last_error, RuntimeError) and b.inflight_rows == 0
    eng.fail_chunks = False
    assert int(b.submit([_fake_spec(2)]).future.result(10)[0][0, 0]) == 2
    assert b.last_error is None
    b.shutdown()


def test_batcher_under_concurrent_submitters():
    """Eight threads submit 25 requests each while the worker admits and
    retires, with a short switch interval: every request resolves to its
    own rows and no row is lost or admitted twice."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b = ContinuousBatcher(FakeEngine(chunk=4), max_queue_rows=1000)
        reqs, lock = [], threading.Lock()

        def submit(base):
            for i in range(25):
                r = b.submit([_fake_spec(base + i)])
                with lock:
                    reqs.append((base + i, r))

        threads = [threading.Thread(target=submit, args=(100 * t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for seed, r in reqs:
            assert int(r.future.result(30)[0][0, 0]) == seed
        assert len(reqs) == 200 and b.admitted_rows == 200 and b.images == 200
        b.shutdown()
        assert not b._worker.is_alive()
    finally:
        sys.setswitchinterval(old)


def test_batcher_over_the_real_engine_gives_the_micro_tokens(engines):
    micro, _ = engines
    cont = ContinuousEngine(micro.model, max_batch=2, chunk_tokens=4, prefill_batch=2, device="cpu")
    cont.warmup()
    assert cont.stats.warmup_batches == 1 and cont.stats.chunks == 0
    specs = [_spec(s) for s in (99, 55, 7)]
    b = ContinuousBatcher(cont)
    reqs = [b.submit([s]) for s in specs]
    outs = [r.future.result(60)[0][0] for r in reqs]
    b.shutdown()
    for s, toks in zip(specs, outs):
        np.testing.assert_array_equal(toks, micro.generate([s])[0][0])


def _checkpoint(tmp_path, pair):
    jm, variables, _ = pair
    jv, vparams, _ = _vae_pair(seed=2)
    cfg = TrainConfig()
    for key, val in dict(
        dim=TINY["dim"], depth=TINY["depth"], heads=TINY["heads"], dim_head=TINY["dim_head"],
        text_seq_len=TINY["text_seq_len"], attn_types="full,axial_row", shift_tokens=True,
        rotary_emb=True, attn_impl="flash",
    ).items():
        setattr(cfg.model, key, val)
    cfg.bf16 = False
    path = tmp_path / "dalle.npz"
    save_dalle_checkpoint(
        str(path), cfg, variables["params"], vparams["params"], epoch=0,
        vae_class_name="DiscreteVAE", vae_hparams=dvae_hparams(jv),
    )
    return path


def _byte_default_vocabulary(monkeypatch):
    """A machine whose default vocabulary cannot load (no C++ toolchain):
    the port's default probe falls back to the byte tokenizer, the
    vocabulary this checkpoint was trained with."""
    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    monkeypatch.setattr(port_tokenizer, "_default_decision", None)
    monkeypatch.setattr(port_tokenizer, "_warned_default_probe", True)


def test_continuous_engine_from_a_reference_checkpoint(tmp_path, monkeypatch):
    """A checkpoint of the byte vocabulary, which the config's default
    probe gives on a machine that cannot load the default one."""
    path = _checkpoint(tmp_path, _dalle_pair(seed=17, **MODEL, num_text_tokens=257))
    _byte_default_vocabulary(monkeypatch)
    eng = engine_from_checkpoint(
        str(path), batch_shapes=(1, 2), device="cpu", mode="continuous",
        kv_dtype="int8", decode_sparsity="policy", chunk_tokens=4,
    )
    assert isinstance(eng, ContinuousEngine) and eng.max_batch == 2
    assert eng.model.kv_dtype == "int8" and eng.model.decode_sparse_block == 128
    assert eng.sparsity_detail()["patterned_layers"] == 1
    b = ContinuousBatcher(eng)
    toks, pixels = b.submit([_spec(3), _spec(4)]).future.result(60)
    b.shutdown()
    assert toks.shape == (2, IMG_SEQ) and toks.dtype == np.int32
    assert 0 <= toks.min() and toks.max() < TINY["num_image_tokens"]
    assert pixels.shape == (2, 32, 32, 3) and np.isfinite(pixels).all()
    assert eng.stats.kv_tiles_read > 0
    micro = engine_from_checkpoint(str(path), batch_shapes=(1,), device="cpu", kv_dtype="int8")
    assert type(micro) is GenerationEngine and micro.model.kv_dtype == "int8"
    paged = engine_from_checkpoint(
        str(path), batch_shapes=(2,), device="cpu", mode="continuous", kv_layout="paged",
        page_size=4, paged_decode_impl="kernel", kv_dtype="int8",
    )
    assert isinstance(paged, PagedContinuousEngine) and paged.paged_decode_impl == "kernel"
    assert paged.model.kv_dtype == "int8" and paged.kv_detail()["page_size"] == 4
    with pytest.raises(NotImplementedError, match="mesh"):
        engine_from_checkpoint(str(path), device="cpu", mode="continuous", mesh="tp=2")


def test_error_probes(pair):
    _, _, pm = pair
    with pytest.raises(ValueError, match="guidance"):
        ContinuousEngine(pm, cond_scale=2.0, device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        ContinuousEngine(pm, decode_sparsity="bogus", device="cpu")
    with pytest.raises(ValueError, match="continuous"):  # before any checkpoint IO
        engine_from_checkpoint("/nonexistent.npz", device="cpu", decode_sparsity="policy")
    with pytest.raises(ValueError, match="mode"):
        engine_from_checkpoint("/nonexistent.npz", device="cpu", mode="paged")
    eng = ContinuousEngine(pm, max_batch=2, prefill_batch=2, device="cpu")
    with pytest.raises(ValueError, match="prefill_batch"):
        eng.prefill_slots([(0, _spec(1)), (1, _spec(2)), (0, _spec(3))])


def test_the_default_device_is_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousEngine(pair[2])
