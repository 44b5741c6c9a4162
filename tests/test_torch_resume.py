"""The port's mid-decode resume vs the JAX package's, and its own
migration contract (CPU).

* `shift_ring_from_prefill_at` equals the JAX function at ends below, at
  and above fmap, and `shift_ring_from_prefill` at end == n.
* `DALLE.decode_resume` against the JAX method (the same weights, both
  on `attn_impl="flash"`: Pallas kernels in interpret mode, the port's
  plain versions) at k in {0, 1, fmap-1, fmap+3, image_seq_len-1}:
  pending logits within 1e-4, K/V below each row's text_len + k and the
  shift rings within 1e-5; k = 0 is `decode_prefill` (1e-6), and each k
  is the port's own prefill + k teacher-forced steps (1e-5, rings 1e-6).
* `resume_into_slots` / `resume_into_slots_paged` against the JAX slot
  ops under one schedule (a live row, then a resume wave, then greedy
  chunks with every step's top-2 image-logit gap asserted above 1e-3),
  float and int8 caches: K/V, rings, logits, positions, tokens.
* Inside the port, the JAX package's pins: a request migrated mid-decode
  (`migrate_out` -> codec -> a fresh engine, `submit(resume=)`) gives the
  uninterrupted run's sampled tokens on the slotted and the paged engine,
  the resumed engine decodes strictly fewer tokens, and
  `dalle_serving_resumed_tokens_total` equals the restored positions; a
  resume next to live traffic; a fully done checkpoint completes without
  a decode; an engine without `resume_enabled` restarts at 0 to the same
  tokens; paged `leak_check()` stays empty.
"""

import copy
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import decode_image_chunk as j_chunk
from dalle_pytorch_tpu.models.dalle import decode_image_chunk_paged as j_chunk_paged
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.models.dalle import init_paged_slot_state as j_init_paged
from dalle_pytorch_tpu.models.dalle import init_slot_state as j_init_slot_state
from dalle_pytorch_tpu.models.dalle import prefill_into_slots as j_prefill
from dalle_pytorch_tpu.models.dalle import resume_into_slots as j_resume
from dalle_pytorch_tpu.models.dalle import resume_into_slots_paged as j_resume_paged
from dalle_pytorch_tpu.ops.shift import shift_ring_from_prefill_at as j_ring_at
from dalle_pytorch_tpu_torch.models.dalle import (
    decode_image_chunk,
    decode_image_chunk_paged,
    init_decode_cache,
    init_paged_slot_state,
    init_slot_state,
    prefill_into_slots,
    resume_into_slots,
    resume_into_slots_paged,
)
from dalle_pytorch_tpu_torch.ops.shift import shift_ring_from_prefill, shift_ring_from_prefill_at
from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    PagedContinuousEngine,
    SampleSpec,
)
from dalle_pytorch_tpu_torch.serving.migrate import (
    MigratedError,
    RequestCheckpoint,
    RowCheckpoint,
    decode_checkpoint,
    encode_checkpoint,
    from_wire,
    to_wire,
)
from dalle_pytorch_tpu_torch.serving.paging import PagedKVManager
from test_torch_dalle import TINY, _dalle_pair, _text

torch.set_num_threads(2)

FMAP = TINY["image_fmap_size"]
IMG_SEQ = FMAP**2
TEXT_LEN = TINY["text_seq_len"] + 1
MAX_POS = TEXT_LEN + IMG_SEQ  # total_seq_len + 1: 7 pages of 4
PAGE = 4
MODEL = dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=True)
MIN_GAP = 1e-3


@pytest.fixture(scope="module")
def pair():
    return _dalle_pair(seed=23, **MODEL)


# ------------------------------------------------------------ shift rings


@pytest.mark.parametrize("ends", [(1, 3), (FMAP, FMAP + 1), (7, 13), (24, 24)])
def test_ring_at_each_rows_end_matches_the_reference(ends):
    h = np.random.RandomState(0).randn(2, 24, 8).astype(np.float32)
    end = np.asarray(ends)
    ours = shift_ring_from_prefill_at(torch.from_numpy(h), FMAP, torch.from_numpy(end))
    ref = j_ring_at(jnp.asarray(h), FMAP, jnp.asarray(end))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for b, e in enumerate(ends):
        if e == h.shape[1]:
            full = shift_ring_from_prefill(torch.from_numpy(h[b : b + 1]), FMAP)
            np.testing.assert_array_equal(ours[b : b + 1].numpy(), full.numpy())


# ------------------------------------------------------------ decode_resume


def _resume_inputs(ks, seed=3):
    text = _text(len(ks), seed=seed)
    toks = np.random.RandomState(seed).randint(0, TINY["num_image_tokens"], (len(ks), IMG_SEQ))
    toks = toks.astype(np.int32)
    for r, k in enumerate(ks):
        toks[r, k:] = 0  # zeros past the prefix, as the engines pack it
    return text, toks, np.asarray(ks, np.int32)


@pytest.mark.parametrize("ks", [(0, 0), (1, FMAP - 1), (FMAP + 3, IMG_SEQ - 1), (0, IMG_SEQ - 1)])
def test_decode_resume_matches_the_reference(pair, ks):
    jm, variables, pm = pair
    text, toks, pos = _resume_inputs(ks)
    b = len(ks)
    resume = jax.jit(lambda v, t, it, ip, c: jm.apply(v, t, it, ip, c, method=JDALLE.decode_resume))
    jrow, jcache = resume(variables, jnp.asarray(text), jnp.asarray(toks), jnp.asarray(pos), j_init_cache(jm, b))
    with torch.inference_mode():
        prow, pcache = pm.decode_resume(
            torch.from_numpy(text), torch.from_numpy(toks), torch.from_numpy(pos), init_decode_cache(pm, b)
        )
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
    for name, jl in jcache.items():
        pl = pcache[name]
        assert "ring_end" not in pl and "ring_end" not in jl
        for r, k in enumerate(ks):
            live = TEXT_LEN + k
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    pl["attn"][key][r, :, :live].numpy(), np.asarray(jl["attn"][key])[r, :, :live],
                    atol=1e-5, rtol=0,
                )
        for key in ("shift_attn", "shift_ff"):
            np.testing.assert_allclose(pl[key].numpy(), np.asarray(jl[key]), atol=1e-5, rtol=0)

    # the port's own incremental path: prefill, then k teacher-forced
    # steps, leaves the same logits and rings (each row on its own)
    with torch.inference_mode():
        for r, k in enumerate(ks):
            cache = init_decode_cache(pm, 1)
            row, cache = pm.decode_prefill(torch.from_numpy(text[r : r + 1]), cache)
            for i in range(k):
                row, cache = pm.decode_image_step(torch.from_numpy(toks[r : r + 1, i]), i, cache)
            np.testing.assert_allclose(row[0].numpy(), prow[r].numpy(), atol=1e-5, rtol=0)
            for name, layer in cache.items():
                for key in ("shift_attn", "shift_ff"):
                    np.testing.assert_allclose(
                        layer[key][0].numpy(), pcache[name][key][r].numpy(), atol=1e-6, rtol=0
                    )
        # k = 0 is decode_prefill, the same batch
        prefill_row, _ = pm.decode_prefill(torch.from_numpy(text), init_decode_cache(pm, b))
        for r, k in enumerate(ks):
            if k == 0:
                np.testing.assert_allclose(prow[r].numpy(), prefill_row[r].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------- slot resume ops


def _image_gap(row, total_text_tokens):
    img = np.sort(np.asarray(row)[:, total_text_tokens:], axis=-1)
    return img[:, -1] - img[:, -2]


def _compare_kv(pleaf, jleaf, int8):
    if int8 and pleaf.dtype == torch.int8:  # rounding may differ by one step
        assert np.abs(pleaf.numpy().astype(np.int32) - np.asarray(jleaf).astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(pleaf.numpy(), np.asarray(jleaf), atol=1e-5, rtol=0)


def _compare_state(jstate, pstate, slots, int8, pages=None):
    for name, jl in jstate["cache"].items():
        pl = pstate["cache"][name]
        for key in ("k", "v", "k_scale", "v_scale"):
            if key in jl["attn"]:
                sel = pages if pages is not None else slots
                _compare_kv(pl["attn"][key][sel], np.asarray(jl["attn"][key])[sel], int8)
        for key in ("shift_attn", "shift_ff"):
            np.testing.assert_allclose(pl[key][slots].numpy(), np.asarray(jl[key])[slots], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pstate["row"][slots].numpy(), np.asarray(jstate["row"])[slots], atol=1e-4, rtol=0)
    for key in ("img_pos", "active", "img_tokens"):
        np.testing.assert_array_equal(pstate[key][slots].numpy(), np.asarray(jstate[key])[slots])
    np.testing.assert_array_equal(pstate["host"]["img_pos"], pstate["img_pos"].numpy())


def _models(pair, kv_dtype):
    jm, variables, pm = pair
    if kv_dtype is None:
        return jm, variables, pm
    pm8 = copy.copy(pm)
    pm8.kv_dtype = kv_dtype
    return jm.clone(kv_dtype=kv_dtype), variables, pm8


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_resume_into_slots_matches_the_reference(pair, kv_dtype):
    jm, variables, pm = _models(pair, kv_dtype)
    int8 = kv_dtype is not None
    texts = _text(3, seed=5)
    jstate = j_init_slot_state(jm, 4)
    pstate = init_slot_state(pm, 4)
    keep = [1, 1]
    # a live row in slot 0, one chunk in
    jstate = j_prefill(jm, variables, jstate, texts[[0, 0]], [0, 0], [9, 9], [1.0, 1.0], keep)
    prefill_into_slots(pm, pstate, texts[[0, 0]], [0, 0], [9, 9], [1.0, 1.0], keep)
    jstate = j_chunk(jm, variables, jstate, 4)
    decode_image_chunk(pm, pstate, 4)
    # a resume wave of two rows at their own positions
    _, toks, pos = _resume_inputs((5, FMAP + 2), seed=7)
    slots, seeds = [2, 1], [3, 4]
    jstate = j_resume(jm, variables, jstate, texts[1:], toks, pos, slots, seeds, [1.0, 1.0], keep)
    resume_into_slots(pm, pstate, texts[1:], toks, pos, slots, seeds, [1.0, 1.0], keep)
    _compare_state(jstate, pstate, [0, 1, 2], int8)
    assert list(pstate["host"]["img_pos"][[2, 1]]) == list(pos)
    for _ in range(4):
        live = np.asarray(jstate["active"]) & (np.asarray(jstate["img_pos"]) < IMG_SEQ)
        gaps = _image_gap(jstate["row"], jm.total_text_tokens)[live]
        assert gaps.size == 0 or gaps.min() >= MIN_GAP, f"greedy not meaningful: {gaps.min()}"
        jstate = j_chunk(jm, variables, jstate, 4)
        decode_image_chunk(pm, pstate, 4)
        _compare_state(jstate, pstate, [0, 1, 2], int8)
    assert (pstate["img_pos"][[0, 1, 2]] == IMG_SEQ).all()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_resume_into_slots_paged_matches_the_reference(pair, kv_dtype):
    jm, variables, pm = _models(pair, kv_dtype)
    int8 = kv_dtype is not None
    texts = _text(2, seed=6)
    kv = PagedKVManager(n_rows=4, page_size=PAGE, max_positions=MAX_POS, text_positions=TEXT_LEN, n_pages=24)
    jstate = j_init_paged(jm, 4, 24, PAGE)
    pstate = init_paged_slot_state(pm, 4, 24, PAGE)
    _, toks, pos = _resume_inputs((6, FMAP * 2 + 1), seed=8)
    slots, seeds, keep = [3, 0], [1, 2], [1, 1]
    page_rows = np.zeros((2, kv.pages_per_row), np.int32)
    for r, slot in enumerate(slots):
        kv.admit_resume(slot, TEXT_LEN + int(pos[r]))
        page_rows[r] = kv.table[slot]
    assert (page_rows[0, 4:] == 0).all()  # past the prefix: the garbage page
    jstate = j_resume_paged(
        jm, variables, jstate, texts, toks, pos, slots, seeds, [1.0, 1.0], keep, page_rows, PAGE
    )
    resume_into_slots_paged(pm, pstate, texts, toks, pos, slots, seeds, [1.0, 1.0], keep, page_rows, PAGE)

    def live_pages():
        return sorted({int(p) for p in kv.table.ravel()} - {0})

    _compare_state(jstate, pstate, slots, int8, pages=live_pages())
    for _ in range(4):
        live = np.asarray(jstate["active"]) & (np.asarray(jstate["img_pos"]) < IMG_SEQ)
        gaps = _image_gap(jstate["row"], jm.total_text_tokens)[live]
        assert gaps.size == 0 or gaps.min() >= MIN_GAP, f"greedy not meaningful: {gaps.min()}"
        for slot in slots:
            end = min(TEXT_LEN + int(pstate["host"]["img_pos"][slot]) + 4, MAX_POS)
            kv.ensure(slot, -(-end // PAGE))
        jstate = j_chunk_paged(jm, variables, jstate, 4, kv.table)
        decode_image_chunk_paged(pm, pstate, 4, kv.table, paged_impl="gather")
        _compare_state(jstate, pstate, slots, int8, pages=live_pages())
    assert (pstate["img_pos"][slots] == IMG_SEQ).all()
    for slot in slots:
        kv.release(slot)
    assert kv.leak_check() == []


# ------------------------------------------------ migration inside the port


def _engine(pm, paged=False, resume=True, max_batch=2):
    cls = PagedContinuousEngine if paged else ContinuousEngine
    kw = dict(page_size=PAGE) if paged else {}
    return cls(
        pm, max_batch=max_batch, chunk_tokens=2, prefill_batch=max_batch, device="cpu",
        resume_enabled=resume, **kw,
    )


def _specs():
    texts = _text(2, seed=11)
    return [
        SampleSpec(texts[0], seed=41, temperature=0.8, top_k=0.5),
        SampleSpec(texts[1], seed=42, temperature=1.0, top_k=0.5),
    ]


def _reference(pm, paged, specs):
    b = ContinuousBatcher(_engine(pm, paged=paged, resume=False, max_batch=len(specs)))
    try:
        return b.submit(specs).future.result(60)[0]
    finally:
        b.shutdown()


def _hold_after(engine, n):
    """Park the worker after its n-th chunk until `gate` is set."""
    reached, gate = threading.Event(), threading.Event()
    step, count = engine.step_chunk, [0]

    def held():
        out = step()
        count[0] += 1
        if count[0] == n:
            reached.set()
            assert gate.wait(60)
        return out

    engine.step_chunk = held
    return reached, gate


def _export(batcher, gate, destructive=True):
    """Ask for an export while the worker is parked, then let it reach the
    boundary: the export sees exactly the parked state."""
    out = {}
    fn = batcher.migrate_out if destructive else batcher.peek_checkpoints
    t = threading.Thread(target=lambda: out.setdefault("cps", fn(timeout_s=60)))
    t.start()
    deadline = time.monotonic() + 30
    while batcher._migrate_request is None and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    t.join(60)
    return out["cps"]


def _counter(batcher, name):
    return int(batcher.registry.get(name).value)


@pytest.mark.parametrize("paged", [False, True])
def test_migrated_resume_gives_the_uninterrupted_tokens(pair, paged):
    _, _, pm = pair
    specs = _specs()
    ref = _reference(pm, paged, specs)

    eng_a = _engine(pm, paged=paged)
    reached, gate = _hold_after(eng_a, 3)
    ba = ContinuousBatcher(eng_a)
    req = ba.submit(specs)
    assert reached.wait(30)
    cps = _export(ba, gate)
    with pytest.raises(MigratedError):
        req.future.result(10)
    ba.shutdown()
    assert len(cps) == 1 and all(0 < r.pos < IMG_SEQ for r in cps[0].rows)
    if paged:
        assert eng_a.kv.leak_check() == []

    fp = eng_a.resume_fingerprint()
    blob = from_wire(to_wire(encode_checkpoint(cps[0], fp)))
    eng_b = _engine(pm, paged=paged)
    assert eng_b.resume_fingerprint() == fp
    bb = ContinuousBatcher(eng_b)
    cp, size = bb.validate_resume(to_wire(blob), specs)
    assert cp is not None and size == len(blob)
    try:
        toks, _ = bb.submit(specs, resume=cp, resume_bytes=size).future.result(60)
    finally:
        bb.shutdown()
    np.testing.assert_array_equal(toks, ref)
    for r, row in enumerate(cp.rows):  # each resumed row starts with its prefix
        np.testing.assert_array_equal(toks[r, : row.pos], row.tokens)
    restored = sum(r.pos for r in cp.rows)
    decoded = _counter(bb, "dalle_serving_decoded_tokens_total")
    assert decoded == 2 * IMG_SEQ - restored < 2 * IMG_SEQ
    assert _counter(bb, "dalle_serving_resumed_tokens_total") == restored
    assert eng_b.stats.resume_dispatches == 1
    if paged:
        assert eng_b.kv.leak_check() == []


def test_resume_next_to_live_traffic(pair):
    _, _, pm = pair
    specs = _specs()
    ref_a = _reference(pm, False, specs[:1])
    ref_b = _reference(pm, False, specs[1:])
    cp = RequestCheckpoint(
        rows=[RowCheckpoint(0, specs[0].text_ids, np.asarray(ref_a[0][:5], np.int32), False, 41, 0.8, 0.5)],
        chunk_index=2, site="elsewhere",
    )
    eng = _engine(pm)
    b = ContinuousBatcher(eng)
    try:
        live = b.submit(specs[1:])
        deadline = time.monotonic() + 30
        while b.inflight_rows < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        resumed = b.submit(specs[:1], resume=cp)
        np.testing.assert_array_equal(resumed.future.result(60)[0], ref_a)
        np.testing.assert_array_equal(live.future.result(60)[0], ref_b)
    finally:
        b.shutdown()
    assert resumed.migrated and resumed.migrated_from == "elsewhere" and resumed.resumed_at_chunk == 2


def test_a_fully_done_checkpoint_completes_without_decode(pair):
    _, _, pm = pair
    specs = _specs()[:1]
    ref = _reference(pm, False, specs)
    cp = RequestCheckpoint(rows=[RowCheckpoint(0, specs[0].text_ids, ref[0], True, 41, 0.8, 0.5)])
    eng = _engine(pm)
    b = ContinuousBatcher(eng)
    try:
        toks, _ = b.submit(specs, resume=cp).future.result(60)
    finally:
        b.shutdown()
    np.testing.assert_array_equal(toks, ref)
    assert _counter(b, "dalle_serving_decoded_tokens_total") == 0
    assert _counter(b, "dalle_serving_resumed_tokens_total") == IMG_SEQ
    assert eng.stats.chunks == 0 and eng.stats.prefills == 0


@pytest.mark.parametrize("paged", [False, True])
def test_an_engine_without_resume_restarts_at_zero_to_the_same_tokens(pair, paged):
    _, _, pm = pair
    specs = _specs()
    ref = _reference(pm, paged, specs)
    cp = RequestCheckpoint(rows=[
        RowCheckpoint(0, specs[0].text_ids, np.asarray(ref[0][:7], np.int32), False, 41, 0.8, 0.5),
        RowCheckpoint(1, specs[1].text_ids, ref[1], True, 42, 1.0, 0.5),
    ])
    eng = _engine(pm, paged=paged, resume=False)
    assert not eng.supports_resume
    b = ContinuousBatcher(eng)
    try:
        toks, _ = b.submit(specs, resume=cp).future.result(60)
    finally:
        b.shutdown()
    np.testing.assert_array_equal(toks, ref)
    assert _counter(b, "dalle_serving_decoded_tokens_total") == IMG_SEQ  # row 0 from 0
    assert _counter(b, "dalle_serving_resumed_tokens_total") == IMG_SEQ  # row 1 verbatim
    assert eng.stats.resume_dispatches == 0
    if paged:
        assert eng.kv.leak_check() == []


def test_resume_warmup_ladder_and_paged_demand(pair):
    _, _, pm = pair
    for paged in (False, True):
        eng = _engine(pm, paged=paged)
        eng.warmup()
        assert "resume" in eng.program_ladder()
        assert eng.stats.resume_dispatches == 0 and eng.stats.warmup_batches == 1
        assert eng.state_dump()["resume_enabled"] is True
        off = _engine(pm, paged=paged, resume=False)
        assert "resume" not in off.program_ladder()
        assert off.resume_fingerprint() != eng.resume_fingerprint()
        with pytest.raises(RuntimeError, match="resume_enabled"):
            off.resume_slots([(0, SampleSpec(_text(1, 1)[0], resume_tokens=np.zeros(2, np.int32), resume_pos=2))])
    spec = _specs()[0]
    resume = SampleSpec(spec.text_ids, seed=1, resume_tokens=np.zeros(3, np.int32), resume_pos=3)
    # a resume row is charged a full row of pages, prefix-cached prompt or not
    assert eng.admission_demand([resume]) == eng.kv.pages_per_row
    assert eng.state_dump()["kv"]["pages_per_row"] == eng.kv.pages_per_row
