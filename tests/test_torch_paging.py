"""The port's paged KV cache and prefix cache vs the JAX package's, and its
own layout contract (CPU).

* Host paging (`serving/paging.py`, copied): the same seeded random walk of
  admissions (prefix hits and misses), lazy `ensure`, releases and LRU
  evictions through the port's and the JAX `PagedKVManager` gives
  identical page tables, refcounts, free lists, prefix entries, headroom
  and demand, and an empty `leak_check`.
* Paged slot ops: one admission schedule (a miss wave registering two
  prompts, chunks, a full-prompt hit with its copy-on-write page, more
  chunks) through JAX `prefill_into_slots_paged` / `admit_cached_prefix` /
  `decode_image_chunk_paged` and the port's, greedy: pages and shift rings
  within 1e-5, the sidecar's and the slots' pending logits within 1e-4,
  tokens and positions equal. Every greedy step's top-2 image-logit gap in
  the JAX run is asserted to exceed 1e-3, so equal tokens mean something.
* Engines: greedy `PagedContinuousEngine` tokens equal the JAX engine's
  under each paged decode impl (the JAX side's chosen by patching its
  module default); inside the port, sampled tokens of the paged engine
  equal the slotted `ContinuousEngine`'s (alone, padded, staggered, a
  shared leading block, full-prompt hits with no prefill dispatch, the
  snapshot page surviving a hit's decode), for both impls.
* The batcher's block gating: requests wait for pages and all complete, a
  request larger than the pool is rejected at submit, a wave's prefix
  hits stay pinned across its splits, and no page leaks.
"""

import numpy as np
import pytest
import torch

import dalle_pytorch_tpu.models.dalle as j_dalle
import dalle_pytorch_tpu.ops.pallas_decode as j_pallas_decode
from dalle_pytorch_tpu.models.dalle import admit_cached_prefix as j_admit
from dalle_pytorch_tpu.models.dalle import decode_image_chunk_paged as j_chunk_paged
from dalle_pytorch_tpu.models.dalle import init_paged_slot_state as j_init_paged
from dalle_pytorch_tpu.models.dalle import prefill_into_slots_paged as j_prefill_paged
from dalle_pytorch_tpu.models.dalle import slice_prefix_sidecar as j_slice_sidecar
from dalle_pytorch_tpu.serving.engine import PagedContinuousEngine as JPagedEngine
from dalle_pytorch_tpu.serving.engine import SampleSpec as JSpec
from dalle_pytorch_tpu.serving.paging import PagedKVManager as JPagedKVManager
from dalle_pytorch_tpu.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.models.dalle import (
    admit_cached_prefix,
    decode_image_chunk_paged,
    init_paged_slot_state,
    prefill_into_slots_paged,
    slice_prefix_sidecar,
)
from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher, QueueFullError
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    PagedContinuousEngine,
    SampleSpec,
)
from dalle_pytorch_tpu_torch.serving.paging import GARBAGE_PAGE, PagedKVManager
from test_torch_dalle import TINY, _dalle_pair

torch.set_num_threads(2)

TEXT_POS = TINY["text_seq_len"] + 1  # 9: two full pages of 4 and a partial one
MAX_POS = TINY["text_seq_len"] + TINY["image_fmap_size"] ** 2 + 1  # 25: 7 pages
IMG_SEQ = TINY["image_fmap_size"] ** 2
PAGE = 4
MODEL = dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=True)
MIN_GAP = 1e-3


def _ids(*head):
    ids = np.zeros(TINY["text_seq_len"], np.int32)
    ids[: len(head)] = head
    return ids


# ------------------------------------------------------------ host paging


def _managers(n_pages=24, max_entries=3):
    kw = dict(
        n_rows=3, page_size=PAGE, max_positions=MAX_POS, text_positions=TEXT_POS,
        n_pages=n_pages, max_entries=max_entries,
    )
    return PagedKVManager(**kw), JPagedKVManager(**kw)


def _assert_same_managers(ours, ref, prompts):
    np.testing.assert_array_equal(ours.table, ref.table)
    assert ours.pool.refcounts() == ref.pool.refcounts()
    assert sorted(ours.pool._free) == sorted(ref.pool._free)
    assert list(ours.cache._entries) == list(ref.cache._entries)
    for key, entry in ours.cache._entries.items():
        other = ref.cache._entries[key]
        assert (entry.full_pages, entry.partial_page) == (other.full_pages, other.partial_page)
    assert (ours.cache.hits, ours.cache.misses, ours.cache.evictions) == (
        ref.cache.hits, ref.cache.misses, ref.cache.evictions
    )
    assert ours.admission_headroom() == ref.admission_headroom()
    assert [ours.row_demand(p) for p in prompts] == [ref.row_demand(p) for p in prompts]
    assert ours.leak_check() == ref.leak_check() == []


@pytest.mark.parametrize("seed", range(6))
def test_manager_random_walk_matches_the_reference(seed):
    """Admit (hit or miss, as an engine would, sharing blocks through the
    chain hashes), ensure ahead of decode, release, evict: identical
    state after every operation."""
    rng = np.random.RandomState(seed)
    ours, ref = _managers()
    prompts = [_ids(*h) for h in ((1,), (1, 2, 3, 4, 5), (1, 2, 3, 4, 9), (7, 7), (1, 2, 3, 4, 5, 6, 7, 8))]
    pos = {}  # live slot -> image position
    for _ in range(80):
        op = rng.randint(4)
        free = [s for s in range(3) if s not in pos]
        if op == 0 and free:
            slot, ids = free[rng.randint(len(free))], prompts[rng.randint(len(prompts))]
            fits = ours.can_admit([ids])
            assert fits == ref.can_admit([ids])
            if not fits:
                continue
            for m in (ours, ref):
                entry = m.cache.lookup_full(ids)
                if entry is not None:
                    assert m.admit_hit(slot, entry)[0] == entry.partial_page
                    m.cache.hits += 1
                    continue
                _, _, _, token = m.admit_miss(slot, ids, register=True)
                if token is not None:
                    m.finish_register(token, sidecar=None)
                m.cache.misses += 1
            pos[slot] = 0
        elif op == 1 and pos:
            slot = list(pos)[rng.randint(len(pos))]
            pos[slot] = min(pos[slot] + 4, IMG_SEQ)
            end = min(TEXT_POS + pos[slot] + 4, MAX_POS)
            for m in (ours, ref):
                m.ensure(slot, -(-end // PAGE))
        elif op == 2 and pos:
            slot = list(pos)[rng.randint(len(pos))]
            del pos[slot]
            for m in (ours, ref):
                m.release(slot)
        elif op == 3:
            assert ours.cache.evict_lru() == ref.cache.evict_lru()
        _assert_same_managers(ours, ref, prompts)
    assert ours.pool.peak_allocated == ref.pool.peak_allocated


def test_manager_accounting_on_a_small_pool():
    ours, _ = _managers(n_pages=15, max_entries=4)  # two rows' worst case
    assert ours.pages_per_row == 7 and ours.n_text_pages == 3 and ours.has_partial
    assert ours.can_ever_admit(2) and not ours.can_ever_admit(3)
    _, snapshot, _, token = ours.admit_miss(0, _ids(1), register=True)
    ours.finish_register(token, sidecar=None)
    assert ours.table[0, :3].tolist() == [1, 2, 3] and (ours.table[0, 3:] == GARBAGE_PAGE).all()
    assert snapshot == 4 and ours.cache.cache_only_pages() == 1  # the snapshot page
    assert ours.can_admit([_ids(2)]) and not ours.can_admit([_ids(2), _ids(3)])
    ours.ensure(0, 7)
    ours.release(0)
    assert (ours.table[0] == GARBAGE_PAGE).all() and ours.leak_check() == []


# --------------------------------------------------------- paged slot ops


@pytest.fixture(scope="module")
def pair():
    return _dalle_pair(seed=17, **MODEL)


def _image_gap(row, total_text_tokens):
    img = np.sort(np.asarray(row)[:, total_text_tokens:], axis=-1)
    return img[:, -1] - img[:, -2]


def _mapped_pages(kv):
    pages = {int(p) for p in kv.table.ravel()}
    for entry in kv.cache._entries.values():
        pages.update(entry.full_pages + [entry.partial_page])
    return sorted(pages - {GARBAGE_PAGE})


def _compare_paged(jstate, pstate, kv, slots):
    pages = _mapped_pages(kv)
    for name, jl in jstate["cache"].items():
        pl = pstate["cache"][name]
        for key in ("k", "v"):
            np.testing.assert_allclose(
                pl["attn"][key][pages].numpy(), np.asarray(jl["attn"][key])[pages], atol=1e-5, rtol=0
            )
        for key in ("shift_attn", "shift_ff"):
            np.testing.assert_allclose(pl[key][slots].numpy(), np.asarray(jl[key])[slots], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pstate["row"][slots].numpy(), np.asarray(jstate["row"])[slots], atol=1e-4, rtol=0)
    for key in ("img_pos", "active", "img_tokens"):
        np.testing.assert_array_equal(pstate[key][slots].numpy(), np.asarray(jstate[key])[slots])
    np.testing.assert_array_equal(pstate["host"]["img_pos"], pstate["img_pos"].numpy())


def test_paged_slot_ops_match_the_reference(pair):
    jm, variables, pm = pair
    texts = np.stack([_ids(3, 1, 4, 1, 5), _ids(9, 2, 6)])
    kv = PagedKVManager(
        n_rows=4, page_size=PAGE, max_positions=MAX_POS, text_positions=TEXT_POS, n_pages=24
    )
    jstate = j_init_paged(jm, 4, 24, PAGE)
    pstate = init_paged_slot_state(pm, 4, 24, PAGE)
    slots, seeds, temps, keep = [2, 0], [5, 6], [1.0, 1.0], [1, 1]

    page_rows = np.zeros((2, kv.n_text_pages), np.int32)
    partial = np.zeros(2, np.int32)
    tokens = []
    for i, slot in enumerate(slots):
        page_rows[i], partial[i], _, token = kv.admit_miss(slot, texts[i], register=True)
        tokens.append(token)
    assert (partial != GARBAGE_PAGE).all()
    jstate, jside = j_prefill_paged(
        jm, variables, jstate, texts, slots, seeds, temps, keep, page_rows, partial, PAGE
    )
    pside = prefill_into_slots_paged(
        pm, pstate, texts, slots, seeds, temps, keep, page_rows, partial, PAGE
    )
    np.testing.assert_allclose(pside["row"].numpy(), np.asarray(jside["row"]), atol=1e-4, rtol=0)
    for name, rings in pside["rings"].items():
        for key, t in rings.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jside["rings"][name][key]), atol=1e-5, rtol=0)
    for i, token in enumerate(tokens):
        kv.finish_register(token, (j_slice_sidecar(jm, jside, i), slice_prefix_sidecar(pside, i)))
    _compare_paged(jstate, pstate, kv, slots)

    def chunk():
        nonlocal jstate
        live = np.asarray(jstate["active"]) & (np.asarray(jstate["img_pos"]) < IMG_SEQ)
        gaps = _image_gap(jstate["row"], jm.total_text_tokens)[live]
        assert gaps.size == 0 or gaps.min() >= MIN_GAP, f"greedy not meaningful: {gaps.min()}"
        for slot in np.flatnonzero(np.asarray(jstate["active"])):
            end = min(TEXT_POS + int(jstate["img_pos"][slot]) + 4, MAX_POS)
            kv.ensure(int(slot), -(-end // PAGE))
        jstate = j_chunk_paged(jm, variables, jstate, 4, kv.table)
        decode_image_chunk_paged(pm, pstate, 4, kv.table, paged_impl="gather")

    chunk()
    _compare_paged(jstate, pstate, kv, slots)
    # a full-prompt hit of row 0's prompt: copy-on-write of its partial page
    entry = kv.cache.lookup_full(texts[0])
    src, dst = kv.admit_hit(1, entry)
    assert src == entry.partial_page and dst not in (src, GARBAGE_PAGE)
    jside0, pside0 = entry.sidecar
    jstate = j_admit(jm, jstate, 1, jside0, 8, 1.0, 1, src, dst, PAGE)
    admit_cached_prefix(pm, pstate, 1, pside0, 8, 1.0, 1, src, dst, PAGE)
    _compare_paged(jstate, pstate, kv, [0, 1, 2])
    for _ in range(4):
        chunk()
    _compare_paged(jstate, pstate, kv, [0, 1, 2])
    assert (pstate["img_pos"][[0, 2]] == IMG_SEQ).all()


def _greedy(spec_cls, head, seed):
    return spec_cls(_ids(*head), seed=seed, temperature=1.0, top_k=1.0)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_greedy_paged_engine_tokens_match_the_reference(pair, impl, monkeypatch):
    jm, variables, pm = pair
    monkeypatch.setattr(j_pallas_decode, "PAGED_DECODE_IMPL", impl)
    j_dalle._jitted_sampler.cache_clear()  # retrace under the patched impl
    try:
        jeng = JPagedEngine(
            jm, variables, max_batch=4, chunk_tokens=4, prefill_batch=2, page_size=PAGE,
            registry=MetricsRegistry(),
        )
        peng = PagedContinuousEngine(
            pm, max_batch=4, chunk_tokens=4, prefill_batch=2, page_size=PAGE,
            paged_decode_impl=impl, device="cpu",
        )
        out = []
        for eng, spec in ((jeng, JSpec), (peng, SampleSpec)):
            a, b, c = (_greedy(spec, h, s) for h, s in (((4, 2), 11), ((4, 2, 8), 12), ((4, 2), 13)))
            eng.prefill_slots([(0, a), (1, b)])
            eng.step_chunk()
            eng.prefill_slot(3, c)  # mid-flight, a full-prompt hit of a's prompt
            assert eng.last_admission_stats["prefix_hits"] == 1
            for _ in range(8):
                pos, act = eng.step_chunk()
                if (pos[act] >= IMG_SEQ).all():
                    break
            out.append(eng.harvest([0, 1, 3]))
            eng.release([0, 1, 3])
        np.testing.assert_array_equal(out[1], out[0])
        assert peng.kv.leak_check() == []
    finally:
        j_dalle._jitted_sampler.cache_clear()


# ------------------------------------------- paged vs slotted, in the port


@pytest.fixture(scope="module", params=["gather", "kernel"])
def engines(request, pair):
    _, _, pm = pair
    slotted = ContinuousEngine(pm, max_batch=4, chunk_tokens=4, prefill_batch=2, device="cpu")
    paged = PagedContinuousEngine(
        pm, max_batch=4, chunk_tokens=4, prefill_batch=2, page_size=PAGE,
        paged_decode_impl=request.param, device="cpu",
    )
    return slotted, paged


def _spec(seed, head=(5, 6, 7), **kw):
    return SampleSpec(_ids(*head), seed=seed, **{"temperature": 1.0, "top_k": 0.5, **kw})


def _drain(eng):
    for _ in range(16):
        pos, act = eng.step_chunk()
        if (pos[act] >= IMG_SEQ).all():
            return
    raise AssertionError("decode never finished")


def _run(eng, waves, slots):
    """Admit `waves` (lists of (slot, spec)), one chunk between waves, then
    drain; returns the slots' tokens and releases them."""
    for i, wave in enumerate(waves):
        if i:
            eng.step_chunk()
        eng.prefill_slots(wave)
    _drain(eng)
    toks = eng.harvest(slots)
    eng.release(slots)
    return toks


@pytest.mark.parametrize(
    "waves",
    [
        [[(0, _spec(1))]],  # alone, in a padded wave
        [[(0, _spec(2)), (1, _spec(3, (9, 9)))]],  # a full wave
        [[(0, _spec(4, (3, 1)))], [(1, _spec(5, (8, 2, 6)))]],  # staggered
        [[(0, _spec(6, (21, 22, 23))), (1, _spec(7, (21, 22, 23, 31)))]],  # a shared block
    ],
    ids=["alone", "full", "staggered", "shared-block"],
)
def test_paged_tokens_equal_the_slotted_engines(engines, waves):
    slotted, paged = engines
    slots = [s for wave in waves for s, _ in wave]
    ref = _run(slotted, waves, slots)
    got = _run(paged, waves, slots)
    np.testing.assert_array_equal(got, ref)
    assert (ref[0] != ref[-1]).any() or len(slots) == 1
    if len(slots) == 2 and len(waves) == 1 and waves[0][0][1].text_ids[0] == 21:
        e1, e2 = (paged.kv.cache.peek_full(sp.text_ids) for _, sp in waves[0])
        assert e1.full_pages[0] == e2.full_pages[0]  # one page for the shared block
        assert e1.full_pages[1] != e2.full_pages[1]
    assert paged.kv.leak_check() == []


def test_full_prompt_hits_run_no_prefill_and_keep_their_snapshot(engines):
    """A repeat of (prompt, seed) admits from the prefix cache with zero
    prefill dispatches and decodes the miss's tokens; two hits in a row
    still do, so each hit decoded into its own copy of the partial page."""
    _, paged = engines
    s = _spec(77, (4, 2, 9, 9))
    cold = _run(paged, [[(0, s)]], [0])
    for slot in (2, 1):
        dispatches = paged.stats.prefill_dispatches
        paged.prefill_slots([(slot, s)])
        st = paged.last_admission_stats
        assert st["prefix_hits"] == 1 and st["dispatches"] == 0 and st["hit_slots"] == [slot]
        assert paged.stats.prefill_dispatches == dispatches
        _drain(paged)
        np.testing.assert_array_equal(paged.harvest([slot]), cold)
        paged.release([slot])
    detail = paged.kv_detail()
    assert detail["prefix_cache"]["hits"] >= 2
    assert detail["blocks_active"] + detail["blocks_free"] == detail["blocks_total"]
    assert paged.kv.leak_check() == []


def test_paged_warmup_and_accounting(pair):
    _, _, pm = pair
    paged = PagedContinuousEngine(pm, max_batch=2, page_size=PAGE, kv_dtype="int8", device="cpu")
    paged.warmup()
    assert paged.stats.warmup_batches == 1 and paged.stats.prefill_dispatches == 0
    assert paged.kv.blocks_active == 0 and len(paged.kv.cache) == 0
    assert paged.kv_pages == 2 * 7 + 1 + 7  # two rows' worst case, garbage, one row of cache
    d, layers = TINY["dim_head"], TINY["depth"]
    page_bytes = layers * TINY["heads"] * PAGE * 2 * (d + 4)  # int8 K/V + fp32 scales
    assert paged.kv_page_bytes() == page_bytes and paged.kv_bytes_per_slot() == 7 * page_bytes
    with pytest.raises(ValueError, match="single row"):
        PagedContinuousEngine(pm, page_size=PAGE, kv_pages=7, device="cpu")
    with pytest.raises(ValueError, match="paged_decode_impl"):
        PagedContinuousEngine(pm, page_size=PAGE, paged_decode_impl="bogus", device="cpu")
    with pytest.raises(ValueError, match="page_size"):  # policy blocks of 4 on pages of 8
        PagedContinuousEngine(
            _small_block(pm), page_size=8, decode_sparsity="policy",
            paged_decode_impl="kernel", device="cpu",
        )


def _small_block(pm):
    import copy

    model = copy.copy(pm)  # the same weights, 4-position policy blocks
    model.decode_sparse_block = 4
    return model


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_paged_policy_int8_tokens_equal_the_slotted_engines(pair, impl):
    """Policy sparsity (axial rows skip 4-position blocks) and int8 KV on
    the paged engine: the slotted engine's tokens, for both impls."""
    _, _, pm = pair
    kw = dict(max_batch=2, chunk_tokens=4, prefill_batch=2, kv_dtype="int8", decode_sparsity="policy", device="cpu")
    slotted = ContinuousEngine(_small_block(pm), **kw)
    paged = PagedContinuousEngine(_small_block(pm), page_size=PAGE, paged_decode_impl=impl, **kw)
    waves = [[(0, _spec(31))], [(1, _spec(32, (2, 7)))]]
    np.testing.assert_array_equal(_run(paged, waves, [0, 1]), _run(slotted, waves, [0, 1]))
    assert paged.stats.kv_tiles_skipped > 0


def test_the_default_device_is_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedContinuousEngine(pair[2], paged_decode_impl="kernel")


# ------------------------------------------------- batcher block gating


def test_batcher_holds_requests_for_pages_and_rejects_what_never_fits(pair):
    """A pool of two rows' worst case behind four slots: the batcher keeps
    requests queued until pages return, every request completes with the
    slotted engine's tokens, a request larger than the pool is refused at
    submit, and the pool is consistent after the drain."""
    _, _, pm = pair
    paged = PagedContinuousEngine(
        pm, max_batch=4, chunk_tokens=4, prefill_batch=2, page_size=PAGE, kv_pages=15,
        paged_decode_impl="kernel", device="cpu",
    )
    slotted = ContinuousEngine(pm, max_batch=4, chunk_tokens=4, prefill_batch=2, device="cpu")
    specs = [_spec(40 + i, (i + 1, 3)) for i in range(4)] + [_spec(40, (1, 3))]
    live, admit = [], paged.prefill_slots

    def recording(assignments):
        admit(assignments)
        live.append(int(paged._state["host"]["active"].sum()))

    paged.prefill_slots = recording
    b = ContinuousBatcher(paged)
    with pytest.raises(QueueFullError, match="block pool"):
        b.submit([_spec(1), _spec(2), _spec(3)])
    reqs = [b.submit([sp]) for sp in specs]
    outs = [r.future.result(60)[0][0] for r in reqs]
    b.shutdown()
    assert max(live) == 2  # two rows' pages at a time, though four slots are free
    assert paged.kv.leak_check() == []
    sb = ContinuousBatcher(slotted)
    for sp, toks in zip(specs, outs):
        np.testing.assert_array_equal(toks, sb.submit([sp]).future.result(60)[0][0])
    sb.shutdown()
    np.testing.assert_array_equal(outs[4], outs[0])  # the repeat: a prefix hit


class FakePagedEngine:
    """The paged admission surface without device work: each row demands
    `demand` pages of a pool of `budget`; splits of a wave record whether
    the wave guard covered them."""

    image_seq_len = 8
    max_batch = 4
    prefill_batch = 1

    def __init__(self, budget=10, demand=7):
        self.budget, self.demand = budget, demand
        self.live = self.peak_live = 0
        self.pos = np.zeros(self.max_batch, np.int64)
        self.active = np.zeros(self.max_batch, bool)
        self.seeds = np.zeros(self.max_batch, np.int64)
        self.protected = None
        self.guarded_splits = []

    def admission_headroom(self):
        return self.budget - self.live * self.demand

    def admission_demand(self, specs):
        return self.demand * len(specs)

    def can_ever_admit(self, specs):
        return self.demand * len(specs) <= self.budget

    def protect_admission_wave(self, assignments):
        self.protected = {int(sp.seed) for _, sp in assignments}
        return set(self.protected)

    def unprotect_admission_wave(self, keys):
        assert keys == self.protected
        self.protected = None

    def prefill_slots(self, assignments):
        self.guarded_splits.append(None if self.protected is None else len(self.protected))
        for slot, sp in assignments:
            self.pos[slot], self.active[slot], self.seeds[slot] = 0, True, sp.seed
            self.live += 1
        self.peak_live = max(self.peak_live, self.live)

    def step_chunk(self):
        self.pos[self.active & (self.pos < self.image_seq_len)] += 4
        return self.pos.copy(), self.active.copy()

    def harvest(self, slots):
        return np.stack([np.full(self.image_seq_len, self.seeds[s], np.int32) for s in slots])

    def release(self, slots):
        for s in slots:
            if self.active[s]:
                self.active[s] = False
                self.live -= 1

    def decode_pixels(self, tokens):
        return None


def _fake_spec(seed):
    return SampleSpec(np.zeros(8, np.int32), seed=seed)


def test_batcher_never_coadmits_a_joint_overrun():
    """Two requests that each fit alone but not together: the second
    waits for the first's release; both complete."""
    eng = FakePagedEngine(budget=10, demand=7)
    b = ContinuousBatcher(eng)
    with b._cond:  # both queue before the worker looks
        r1, r2 = b.submit([_fake_spec(1)]), b.submit([_fake_spec(2)])
    assert [int(r.future.result(10)[0][0, 0]) for r in (r1, r2)] == [1, 2]
    assert eng.peak_live == 1
    with pytest.raises(QueueFullError, match="block pool"):
        b.submit([_fake_spec(3), _fake_spec(4)])
    b.shutdown()


def test_batcher_pins_a_wave_across_its_splits():
    """A two-row request is one wave dispatched in two splits of
    prefill_batch 1: both run under the guard of the whole wave, taken
    once and dropped once."""
    eng = FakePagedEngine(budget=20, demand=5)
    b = ContinuousBatcher(eng)
    toks, _ = b.submit([_fake_spec(5), _fake_spec(6)]).future.result(10)
    b.shutdown()
    assert [int(t[0]) for t in toks] == [5, 6]
    assert eng.guarded_splits == [2, 2] and eng.protected is None


def test_batcher_gating_leaves_slotted_engines_alone(pair):
    """An engine without the paged hooks admits on slots alone."""
    _, _, pm = pair
    eng = ContinuousEngine(pm, max_batch=2, chunk_tokens=4, prefill_batch=2, device="cpu")
    assert not hasattr(eng, "admission_headroom")
    b = ContinuousBatcher(eng)
    outs = [r.future.result(60)[0] for r in [b.submit([_spec(s)]) for s in (1, 2, 3)]]
    b.shutdown()
    assert [t.shape for t in outs] == [(1, IMG_SEQ)] * 3 and b.admitted_rows == 3
