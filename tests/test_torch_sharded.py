"""The port's tensor-parallel serving vs the JAX package's sharded serving
(CPU), and its own contracts.

* Placement rules: every DALLE parameter's spec against the JAX
  `partition_params` spec on the 8-device virtual CPU mesh, dimension by
  dimension through `weights.py`'s name and transpose map, and every
  decode-state leaf's against `decode_state_shardings` (slotted, paged,
  int8). The one intended difference: the port splits `to_qkv` per q/k/v
  part and `dense_0` per GEGLU half, in whole heads, where GSPMD cuts the
  joined columns and reshards; so a head count the axis does not divide
  replicates the attention parameters in the port.
* Mesh flags: `parse_mesh_shape` / `build_serving_mesh`, their rejections,
  the axes in lockstep with the JAX package's and the port's
  `parallel/mesh.py`, one device named twice.
* The head-split kernel wrappers (plain arms on the CPU) against JAX's
  `sharded_flash_decode_attention` / `sharded_paged_decode_attention` at
  tp = 2 under the port's fp32 `decode_tol` (2e-5 of the largest output),
  and the shards' outputs joined by head equal to the unsharded call's
  bits.
* The engines: first-position logits of the port's sharded slotted and
  paged engines at tp = 2 against the JAX sharded engines' within 1e-4
  (the fp32 pending-logits tolerance of `test_torch_continuous.py`),
  greedy tokens equal; inside the port, tp = 1 bit-identical to the
  unsharded engine, tp = 2, 4 and 8 (splits that drop to replicated
  included) equal in tokens and within 1e-4 in logits, with mid-flight
  admission, a prefix-cache hit and resume at a position.
* The cached decode honours `reverse_model`, as the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.models.dalle import init_paged_slot_state as j_init_paged_state
from dalle_pytorch_tpu.models.dalle import init_slot_state as j_init_slot_state
from dalle_pytorch_tpu.ops.pallas_decode import sharded_flash_decode_attention as j_sharded_flash
from dalle_pytorch_tpu.ops.pallas_decode import sharded_paged_decode_attention as j_sharded_paged
from dalle_pytorch_tpu.parallel import mesh as j_mesh
from dalle_pytorch_tpu.parallel.partition import partition_params as j_partition_params
from dalle_pytorch_tpu.parallel.serving_partition import decode_state_shardings
from dalle_pytorch_tpu.serving import sharded as j_sharded
from dalle_pytorch_tpu.serving.engine import SampleSpec as JSpec
from dalle_pytorch_tpu.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.models.dalle import DALLE, init_decode_cache, init_paged_slot_state, init_slot_state
from dalle_pytorch_tpu_torch.models.transformer import cached_forward
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    block_sparse_flash_decode_attention,
    flash_decode_attention,
    paged_decode_attention,
    sharded_flash_decode_attention,
    sharded_paged_decode_attention,
)
from dalle_pytorch_tpu_torch.parallel import mesh as p_mesh
from dalle_pytorch_tpu_torch.parallel.partition import partition_params
from dalle_pytorch_tpu_torch.parallel.serving_partition import decode_state_placements
from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TensorParallelDALLE
from dalle_pytorch_tpu_torch.serving import sharded
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    PagedContinuousEngine,
    SampleSpec,
    engine_from_checkpoint,
)
from dalle_pytorch_tpu_torch.serving.server import ServingServer
from dalle_pytorch_tpu_torch.serving.sharded import (
    ShardedContinuousEngine,
    ShardedPagedContinuousEngine,
    build_serving_mesh,
    parse_mesh_shape,
)
from dalle_pytorch_tpu_torch.weights import _dalle_targets, _dense_t, shard_dalle_params
from test_torch_dalle import TINY, _assert_cache_close, _dalle_pair, _text

torch.set_num_threads(2)

IMG_SEQ = TINY["image_fmap_size"] ** 2
LOGIT_TOL = 1e-4
CPU = "cpu"


def _port_mesh(tp):
    return build_serving_mesh({"tp": tp}, device=CPU)


def _jax_spec(spec, rank, transpose):
    spec = tuple(spec) + (None,) * (rank - len(spec))
    spec = spec[::-1] if transpose else spec
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _jax_flat(shardings):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): s.spec
        for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]
    }


# ------------------------------------------------------ placement rules


_PAIRS: dict = {}


def _param_pair(**overrides):
    """(JAX params, the port DALLE with the same weights), the JAX side's
    parameters from `_dalle_pair`; built once per configuration."""
    key = tuple(sorted(overrides.items()))
    if key not in _PAIRS:
        _, variables, pm = _dalle_pair(seed=5, **overrides)
        _PAIRS[key] = variables["params"], pm
    return _PAIRS[key]


@pytest.mark.parametrize("tp", [2, 4])
def test_param_specs_match_the_reference(tp):
    params, pm = _param_pair(rotary_emb=False)  # with the text positional table
    jflat = _jax_flat(j_partition_params(params, j_sharded.build_serving_mesh({"tp": tp})))
    mine = partition_params(pm, _port_mesh(tp))
    names = {id(t): n for n, t in pm.state_dict(keep_vars=True).items()}
    for path, (param, fn) in _dalle_targets(pm).items():
        name = names[id(param)]
        want = _jax_spec(jflat[path], param.dim(), fn is _dense_t)
        assert mine[name].spec == want, (name, path, mine[name].spec, want)
    assert mine["transformer.attn.0.to_qkv.weight"].spec == ("tp", "fsdp")


def test_attention_and_geglu_split_per_part():
    """The intended difference: shard s holds heads s of q, of k and of v,
    and hidden units s of the GEGLU value and gate halves."""
    _, pm = _param_pair()
    tp, heads, dh = 2, TINY["heads"], TINY["dim_head"]
    shards = shard_dalle_params(pm, _port_mesh(tp))
    qkv = pm.transformer.attn["0"].to_qkv.weight
    inner = heads * dh
    for s in range(tp):
        rows = [qkv[part * inner + s * inner // tp: part * inner + (s + 1) * inner // tp] for part in range(3)]
        assert torch.equal(shards[s]["transformer.attn.0.to_qkv.weight"], torch.cat(rows))
    d0 = pm.transformer.ff["0"].dense_0.weight
    hidden = d0.shape[0] // 2
    for s in range(tp):
        rows = [d0[half * hidden + s * hidden // tp: half * hidden + (s + 1) * hidden // tp] for half in range(2)]
        assert torch.equal(shards[s]["transformer.ff.0.dense_0.weight"], torch.cat(rows))


def _join(pieces, placement):
    """Shards of one parameter joined back: piece k of each of the
    placement's parts, in shard order, part after part."""
    dim = placement.split_dim("tp")
    if dim is None or len(pieces) == 1:
        return pieces[0]
    parts = [p.chunk(placement.parts, dim) for p in pieces]
    return torch.cat([p[k] for k in range(placement.parts) for p in parts], dim)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_shards_join_back_exactly(tp):
    _, pm = _param_pair()
    mesh = _port_mesh(tp)
    shards, placements = shard_dalle_params(pm, mesh), partition_params(pm, mesh)
    for name, full in pm.state_dict().items():
        pieces = [sh[name] for sh in shards]
        assert all(torch.equal(p, full) for p in pieces) or placements[name].split_dim("tp") is not None, name
        assert torch.equal(_join(pieces, placements[name]), full), name


def test_nondividing_heads_fall_back_to_replicated():
    """Two heads on tp = 8: the decode state's K/V replicate, as in JAX;
    the port replicates the attention parameters too (whole heads), where
    GSPMD still cuts the joined 48 columns."""
    params, pm = _param_pair(heads=2)
    jm = JDALLE(**{**TINY, "heads": 2})
    jmesh, mesh = j_sharded.build_serving_mesh({"tp": 8}), _port_mesh(8)
    jstate = _jax_flat(decode_state_shardings(j_init_slot_state(jm, 4), jmesh))
    placements = decode_state_placements(init_slot_state(pm, 4), mesh)
    assert jstate["cache/layer_0/attn/k"] == jax.sharding.PartitionSpec()
    assert placements[("cache", "layer_0", "attn", "k")].spec == ()
    mine = partition_params(pm, mesh)
    assert mine["transformer.attn.0.to_qkv.weight"].spec == (None, "fsdp")
    assert mine["transformer.attn.0.to_out.weight"].spec == ("fsdp",)
    jflat = _jax_flat(j_partition_params(params, jmesh))
    assert "tp" in tuple(jflat["transformer/attn_0/to_qkv/kernel"])


@pytest.mark.parametrize("layout", ["slot", "paged", "slot-int8", "paged-int8"])
def test_decode_state_specs_match_the_reference(layout):
    kv = "int8" if layout.endswith("int8") else None
    jm = JDALLE(**TINY, kv_dtype=kv)
    pm = DALLE(**TINY, kv_dtype=kv)
    if layout.startswith("paged"):
        jstate, pstate = j_init_paged_state(jm, 4, n_pages=9, page_size=4), init_paged_slot_state(pm, 4, 9, 4)
    else:
        jstate, pstate = j_init_slot_state(jm, 4), init_slot_state(pm, 4)
    jflat = _jax_flat(decode_state_shardings(jstate, j_sharded.build_serving_mesh({"tp": 2})))
    mine = decode_state_placements(pstate, _port_mesh(2))
    assert set(mine) == {tuple(p.split("/")) for p in jflat if p != "seeds"}
    for path, placement in mine.items():
        assert placement.spec == _jax_spec(jflat["/".join(path)], 0, False), path
    assert mine[("cache", "layer_0", "attn", "k")].spec == (None, "tp")
    assert mine[("row",)].spec == (None, "tp")


# ----------------------------------------------------------- mesh flags


def test_parse_axis_pairs():
    assert parse_mesh_shape("dp=2,tp=4") == {"dp": 2, "tp": 4}
    assert parse_mesh_shape(" tp=-1 ") == {"tp": -1}
    assert parse_mesh_shape(None) == {"tp": -1}


@pytest.mark.parametrize("spec, message", [
    ("pp=2", "unknown mesh axis"), ("2,4", "must be axis=size"), ("tp=0", "sizes must be >= 1"),
    ("tp=-2", "sizes must be >= 1"),
])
def test_parse_rejections(spec, message):
    with pytest.raises(ValueError, match=message):
        parse_mesh_shape(spec)


def test_build_rules():
    mesh = build_serving_mesh({"tp": 2}, device=CPU)
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 2, "sp": 1} and mesh.size == 2
    assert build_serving_mesh("dp=2,tp=-1", device=CPU).shape["tp"] == p_mesh.CPU_MESH_DEVICES // 2
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        build_serving_mesh({"tp": 16}, device=CPU)
    with pytest.raises(ValueError, match="sizes must be >= 1"):
        build_serving_mesh({"tp": 0}, device=CPU)
    twice = build_serving_mesh({"tp": 2}, devices=["cpu", "cpu"])
    assert [str(d) for d in twice.axis_devices("tp")] == ["cpu", "cpu"]


def test_mesh_axes_in_lockstep_with_the_reference():
    assert tuple(sharded.MESH_AXES) == tuple(p_mesh.MESH_AXES) == tuple(j_mesh.MESH_AXES)
    assert tuple(j_sharded.MESH_AXES) == tuple(p_mesh.MESH_AXES)


# -------------------------------------------------- head-split wrappers


def _decode_case(int8, seed=0, b=3, h=4, n=1, s=32, d=8):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in ((b, h, n, d), (b, h, s, d), (b, h, s, d)))
    lengths = np.array([5, 17, 32], np.int32)[:b]
    ks = vs = None
    if int8:
        from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize

        (k, ks), (v, vs) = (tuple(np.array(x) for x in j_quantize(jnp.asarray(t))) for t in (k, v))
    return q, k, v, ks, vs, lengths


def _split(x, tp, dim=1):
    return None if x is None else [p.contiguous() for p in torch.from_numpy(x).chunk(tp, dim)]


def _heads(outs):
    """The shards' outputs joined by head."""
    return torch.cat(outs, dim=1)


def _decode_tol(ref):
    return 2e-5 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("int8, sparse, n", [
    (False, False, 1), (False, False, 5), (True, False, 1), (False, True, 1), (True, True, 5),
], ids=["step", "chunk", "int8", "bitmap", "int8-bitmap-chunk"])
def test_sharded_flash_decode_matches_the_reference(int8, sparse, n):
    q, k, v, ks, vs, lengths = _decode_case(int8, n=n)
    bitmap = np.array([[1, 0, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1]], np.int32) if sparse else None
    jmesh = j_sharded.build_serving_mesh({"tp": 2})
    jk = dict(k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs))
    if sparse:
        jk.update(block_bitmap=jnp.asarray(bitmap), sparse_block=8)
    ref = np.asarray(j_sharded_flash(jmesh, *(jnp.asarray(t) for t in (q, k, v, lengths)), **jk))
    lens = torch.from_numpy(lengths)
    outs = sharded_flash_decode_attention(
        _split(q, 2), _split(k, 2), _split(v, 2), lens, _split(ks, 2), _split(vs, 2),
        block_bitmap=None if bitmap is None else torch.from_numpy(bitmap), sparse_block=8 if sparse else None,
    )
    got = _heads(outs).numpy()
    np.testing.assert_allclose(got, ref, atol=_decode_tol(ref), rtol=0)
    args = [torch.from_numpy(t) for t in (q, k, v)] + [lens]
    sc = [None if t is None else torch.from_numpy(t) for t in (ks, vs)]
    whole = (block_sparse_flash_decode_attention(*args, torch.from_numpy(bitmap), 8, *sc) if sparse
             else flash_decode_attention(*args, *sc))
    assert torch.equal(_heads(outs), whole)


def test_sharded_flash_decode_runs_nondividing_heads_whole():
    q, k, v, _, _, lengths = _decode_case(False, h=3)
    whole = flash_decode_attention(*(torch.from_numpy(t) for t in (q, k, v, lengths)))
    outs = sharded_flash_decode_attention([torch.from_numpy(q)] * 2, [torch.from_numpy(k)] * 2,
                                          [torch.from_numpy(v)] * 2, torch.from_numpy(lengths))
    assert all(torch.equal(o, whole) for o in outs)
    ref = np.asarray(j_sharded_flash(j_sharded.build_serving_mesh({"tp": 2}),
                                     *(jnp.asarray(t) for t in (q, k, v, lengths))))
    np.testing.assert_allclose(whole.numpy(), ref, atol=_decode_tol(ref), rtol=0)


@pytest.mark.parametrize("impl, int8, sparse", [
    ("gather", False, False), ("kernel", True, False), ("gather", True, True), ("kernel", False, True),
], ids=["gather", "kernel-int8", "gather-int8-bitmap", "kernel-bitmap"])
def test_sharded_paged_decode_matches_the_reference(impl, int8, sparse):
    b, h, page, n_pages, d = 3, 4, 8, 4, 8
    q, k, v, ks, vs, lengths = _decode_case(int8, b=b, h=h, s=page * n_pages, d=d, seed=3)
    rng = np.random.RandomState(4)
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    table[1, 0] = table[0, 0]
    pool = lambda t, tail: np.concatenate(  # noqa: E731 - row r's block j at page table[r, j]
        [np.zeros((1, h, page) + tail, t.dtype)]
        + [t[r, :, j * page:(j + 1) * page][None] for r, j in sorted(
            ((r, j) for r in range(b) for j in range(n_pages)), key=lambda rj: table[rj])])
    kp, vp = pool(k, (d,)), pool(v, (d,))
    ksp = None if ks is None else pool(ks, ())
    vsp = None if vs is None else pool(vs, ())
    bitmap = np.array([[1, 0, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1]], np.int32) if sparse else None
    vlen = page * n_pages
    jk = dict(impl=impl, k_scale=None if ksp is None else jnp.asarray(ksp),
              v_scale=None if vsp is None else jnp.asarray(vsp))
    if sparse:
        jk.update(block_bitmap=jnp.asarray(bitmap), sparse_block=page)
    ref = np.asarray(j_sharded_paged(j_sharded.build_serving_mesh({"tp": 2}),
                                     *(jnp.asarray(t) for t in (q, kp, vp, lengths, table)), vlen, **jk))
    lens, tab = torch.from_numpy(lengths), torch.from_numpy(table)
    bm = None if bitmap is None else torch.from_numpy(bitmap)
    outs = sharded_paged_decode_attention(
        _split(q, 2), _split(kp, 2), _split(vp, 2), lens, tab, vlen, impl, _split(ksp, 2), _split(vsp, 2),
        block_bitmap=bm, sparse_block=page if sparse else None,
    )
    got = _heads(outs)
    np.testing.assert_allclose(got.numpy(), ref, atol=_decode_tol(ref), rtol=0)
    sc = [None if t is None else torch.from_numpy(t) for t in (ksp, vsp)]
    whole = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), lens, tab,
                                   vlen, impl, *sc, block_bitmap=bm, sparse_block=page if sparse else None)
    assert torch.equal(got, whole)


# ------------------------------------------------------------- engines


MODEL = dict(shift_tokens=True, rotary_emb=True)


@pytest.fixture(scope="module")
def pair():
    return _dalle_pair(seed=23, **MODEL)


def _spec(seed, cls=SampleSpec, **kw):
    return cls(_text(1, seed=seed % 5)[0], seed=seed, **{"temperature": 1.0, "top_k": 0.5, **kw})


def _drain(engine):
    for _ in range(16):
        pos, act = engine.step_chunk()
        if (pos[act] >= IMG_SEQ).all():
            return
    raise AssertionError("decode never finished")


def _pending(engine):
    """The engine's pending logits [S, V] (over shards, gathered)."""
    return engine.tp_model.gather_logits([st["row"] for st in engine._state["shards"]])


def _serve(engine, specs, late, resume=False):
    """Admit `specs` into slots 0.., one chunk, `late` mid-flight, drain;
    returns (tokens, pending logits after the first wave). With `resume`,
    slot 0 is preempted after the first chunk and resumed at its
    position."""
    engine.prefill_slots([(i, s) for i, s in enumerate(specs)])
    first = _pending(engine).clone()
    pos, _ = engine.step_chunk()
    if resume:
        prefix = engine.snapshot_rows([0])[0]
        engine.release([0])
        s = specs[0]
        engine.resume_slots([(0, SampleSpec(s.text_ids, seed=s.seed, temperature=s.temperature, top_k=s.top_k,
                                            resume_tokens=prefix[: pos[0]].copy(), resume_pos=int(pos[0])))])
    engine.prefill_slot(len(specs), late)
    _drain(engine)
    slots = list(range(len(specs) + 1))
    toks = engine.harvest(slots)
    engine.release(slots)
    return toks, first


def _engine_kw(layout):
    kw = dict(max_batch=4, chunk_tokens=4, prefill_batch=2, device=CPU, resume_enabled=True)
    if layout == "paged":
        kw.update(page_size=4, paged_decode_impl="kernel")
    return kw


def _classes(layout):
    return ((PagedContinuousEngine, ShardedPagedContinuousEngine) if layout == "paged"
            else (ContinuousEngine, ShardedContinuousEngine))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_tp1_is_the_unsharded_engine_bit_for_bit(pair, layout):
    _, _, pm = pair
    plain, cls = _classes(layout)
    specs, late = [_spec(3), _spec(4, temperature=0.7)], _spec(3)  # the late one a prefix hit
    want = _serve(plain(pm, **_engine_kw(layout)), specs, late, resume=True)
    got = _serve(cls(pm, mesh="tp=1", **_engine_kw(layout)), specs, late, resume=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp32", "int8"])
def test_tp2_tokens_and_logits(pair, layout, kv):
    """Mid-flight admission, a prefix-cache hit (paged) and resume at a
    position: the unsharded engine's tokens, logits within LOGIT_TOL; the
    state split by the rules."""
    _, _, pm = pair
    plain, cls = _classes(layout)
    specs, late = [_spec(5), _spec(6, top_k=0.9)], _spec(5)
    kw = dict(_engine_kw(layout), kv_dtype=kv)
    want = _serve(plain(pm, **kw), specs, late, resume=True)
    engine = cls(pm, mesh="tp=2", **kw)
    got = _serve(engine, specs, late, resume=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=LOGIT_TOL, rtol=0)
    st = engine._state["shards"]
    heads = TINY["heads"]
    assert [s["cache"]["layer_0"]["attn"]["k"].shape[1] for s in st] == [heads // 2] * 2
    assert [s["row"].shape[1] for s in st] == [pm.total_tokens // 2] * 2
    if kv:
        assert st[1]["cache"]["layer_0"]["attn"]["k_scale"].shape[1] == heads // 2
    if layout == "paged":
        assert engine.last_admission_stats["prefix_hits"] == 1 and engine.kv.leak_check() == []


@pytest.mark.parametrize("tp", [4, 8])
def test_axes_that_do_not_divide_replicate(pair, tp):
    """TINY's text vocabulary (58) and logits (90) do not divide 4; at 8
    neither do its 4 heads: those layers run whole on every shard."""
    _, _, pm = pair
    engine = ShardedContinuousEngine(pm, mesh={"tp": tp}, **_engine_kw("slot"))
    tpm = engine.tp_model
    assert (tpm.split_heads, tpm.split_text, tpm.split_image, tpm.split_logits) == (tp == 4, False, True, False)
    want = _serve(ContinuousEngine(pm, **_engine_kw("slot")), [_spec(8)], _spec(9))
    got = _serve(engine, [_spec(8)], _spec(9))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("vocab", ["split", "whole"])
def test_shared_input_output_embedding(vocab, layout):
    """A head tied to the embeddings. "split": each shard's logits are its
    text and its image slice, joined back in vocabulary order. "whole":
    neither vocabulary divides tp (59 text + 33 image tokens) though their
    sum does, so the head and the pending logits stay whole on every
    shard."""
    torch.manual_seed(3)
    kw = {} if vocab == "split" else dict(num_text_tokens=59 - TINY["text_seq_len"], num_image_tokens=33)
    pm = DALLE(**{**TINY, **kw}, share_input_output_emb=True, attn_impl="flash").eval()
    plain, cls = _classes(layout)
    engine = cls(pm, mesh="tp=2", **_engine_kw(layout))
    tpm = engine.tp_model
    if vocab == "split":
        assert tpm.head_segments[1] == [(29, 29), (pm.total_text_tokens + 16, 16)]
    else:
        assert (pm.total_tokens % 2, tpm.split_logits) == (0, False)
        assert [st["row"].shape[1] for st in engine._state["shards"]] == [pm.total_tokens] * 2
    want = _serve(plain(pm, **_engine_kw(layout)), [_spec(8)], _spec(9))
    got = _serve(engine, [_spec(8)], _spec(9))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=LOGIT_TOL, rtol=0)


def _greedy(seed, cls):
    return _spec(seed, cls=cls, top_k=1.0)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_tp2_matches_the_reference_sharded_engine(pair, layout):
    jm, variables, pm = pair
    jmesh = j_sharded.build_serving_mesh({"tp": 2})
    kw = dict(max_batch=4, chunk_tokens=8, prefill_batch=2)
    if layout == "paged":
        kw.update(page_size=4)
        jeng = j_sharded.ShardedPagedContinuousEngine(model=jm, variables=variables, mesh=jmesh,
                                                      registry=MetricsRegistry(), **kw)
        peng = ShardedPagedContinuousEngine(pm, mesh="tp=2", device=CPU, **kw)
    else:
        jeng = j_sharded.ShardedContinuousEngine(model=jm, variables=variables, mesh=jmesh,
                                                 registry=MetricsRegistry(), **kw)
        peng = ShardedContinuousEngine(pm, mesh="tp=2", device=CPU, **kw)
    out, rows = [], []
    for eng, cls in ((jeng, JSpec), (peng, SampleSpec)):
        eng.prefill_slots([(0, _greedy(1, cls)), (1, _greedy(2, cls))])
        rows.append(np.asarray(_pending(eng) if eng is peng else eng._state["row"])[:2])
        eng.step_chunk()
        eng.prefill_slot(2, _greedy(3, cls))
        _drain(eng)
        out.append(eng.harvest([0, 1, 2]))
        eng.release([0, 1, 2])
    np.testing.assert_allclose(rows[1], rows[0], atol=LOGIT_TOL, rtol=0)
    gaps = np.sort(rows[0][:, pm.total_text_tokens:], axis=-1)
    assert (gaps[:, -1] - gaps[:, -2]).min() > 2 * LOGIT_TOL
    np.testing.assert_array_equal(out[1], out[0])


def test_mesh_detail_and_healthz(pair):
    _, _, pm = pair
    engine = ShardedPagedContinuousEngine(pm, mesh="tp=2", **_engine_kw("paged"))
    engine.warmup()
    dump = engine.state_dump()["mesh"]
    assert dump["axes"]["tp"] == 2 and dump["devices"] == 2 and dump["model_axis"] == "tp"
    per = dump["per_device_state_bytes"]
    assert list(per) == ["tp0:cpu", "tp1:cpu"] and len(set(per.values())) == 1 and min(per.values()) > 0
    server = ServingServer(engine, port=0)
    try:
        healthy, detail = server.health()
        assert healthy and detail["mesh"]["axes"]["tp"] == 2
    finally:
        server.shutdown(drain=False)


def test_unserved_axes_and_devices_raise(pair):
    _, _, pm = pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        ShardedContinuousEngine(pm, mesh="dp=2,tp=2", device=CPU)
    with pytest.raises(ValueError, match="needs 16 devices"):
        ShardedContinuousEngine(pm, mesh="tp=16", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ShardedContinuousEngine(pm, mesh="tp=2")


def test_engine_from_checkpoint_builds_the_sharded_engines(pair, tmp_path, monkeypatch):
    from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.training.pipeline import dalle_config, dvae_hparams, save_dalle_checkpoint
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    torch.manual_seed(0)
    vocab = port_tokenizer.get_tokenizer().vocab_size
    model = DALLE(dim=32, depth=1, heads=2, dim_head=8, num_image_tokens=16, image_fmap_size=4,
                  num_text_tokens=vocab, text_seq_len=8, attn_impl="flash")
    vae = DiscreteVAE(image_size=16, num_layers=2, num_tokens=16, codebook_dim=8, hidden_dim=8)
    path = str(tmp_path / "dalle.npz")
    save_dalle_checkpoint(path, dalle_config(model, bf16=False), model,
                          vae_params=export_dvae_params(vae), vae_hparams=dvae_hparams(vae))
    kw = dict(mode="continuous", batch_shapes=(2,), device=CPU, resume_enabled=False, preview_enabled=False)
    slot = engine_from_checkpoint(path, mesh="tp=2", **kw)
    paged = engine_from_checkpoint(path, mesh={"tp": 2}, kv_layout="paged", page_size=4, **kw)
    assert type(slot) is ShardedContinuousEngine and type(paged) is ShardedPagedContinuousEngine
    ids = slot.tokenize("red")
    toks = []
    for engine in (slot, paged, engine_from_checkpoint(path, **kw)):
        engine.prefill_slot(0, SampleSpec(ids, seed=4))
        _drain(engine)
        toks.append(engine.harvest([0]))
    np.testing.assert_array_equal(toks[0], toks[2])
    np.testing.assert_array_equal(toks[1], toks[2])
    assert slot.decode_pixels(toks[0]).shape == (1, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        engine_from_checkpoint(path, mesh="fsdp=2", **kw)
    with pytest.raises(ValueError, match="continuous"):
        engine_from_checkpoint(path, mesh="tp=2", device=CPU)


# ------------------------------------------------ reverse_model, cached


@pytest.mark.parametrize("tp", [None, 2], ids=["unsharded", "tp2"])
def test_cached_decode_honours_reverse_model(pair, tp):
    """The cached trunk with `reverse_model=True` against the reference's
    (`transformer.py:789`: the layers in `order`), a prefill then steps."""
    jm, variables, pm = pair
    b = 2
    text = _text(b, seed=2)
    _, tokens = pm.embed_text(torch.from_numpy(text))
    x = tokens.detach().numpy()
    jfwd = jax.jit(lambda v, h, c: jm.apply(v, h, c, method=lambda m, h, c: m.transformer(
        h, reverse_model=True, cache=c)))
    jout, jcache = jfwd(variables, jnp.asarray(x), j_init_cache(jm, b))
    steps = [np.random.RandomState(i).randn(b, 1, TINY["dim"]).astype(np.float32) for i in range(3)]
    jsteps = []
    for h in steps:
        out, jcache = jfwd(variables, jnp.asarray(h), jcache)
        jsteps.append(np.asarray(out))
    with torch.inference_mode():
        if tp is None:
            cache = init_decode_cache(pm, b)
            outs = [pm.transformer(torch.from_numpy(h), cache, reverse_model=True) for h in [x] + steps]
            _assert_cache_close(jcache, cache)
        else:
            tpm = TensorParallelDALLE(pm, _port_mesh(tp))
            caches = [init_decode_cache(sh, b) for sh in tpm.shards]
            outs = [cached_forward([sh.transformer for sh in tpm.shards], [torch.from_numpy(h)] * tp,
                                   caches, reverse_model=True)[0] for h in [x] + steps]
    for got, want in zip(outs, [np.asarray(jout)] + jsteps):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
