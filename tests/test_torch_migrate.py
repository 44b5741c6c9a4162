"""The port's decode-state checkpoints (CPU): codec, spool, fingerprints,
and the batcher's export and beacon.

* Codec: round trip, fingerprint mismatch -> `CheckpointMismatch`,
  truncated / garbled / bad-magic blobs and bad base64 ->
  `CheckpointCorrupt`, a format bump -> mismatch (not corrupt).
* Across packages: the port's blob is the JAX package's byte for byte,
  a JAX `encode_checkpoint` blob decodes in the port and the reverse,
  under one fingerprint string; so does the artifact container.
* Spool: write / read / clear, latest state only, the byte cap drops the
  largest entry, a torn tail line is skipped and counted.
* Fingerprints: two engines on the same weights and config agree; a
  change of model, config, ladder, torch version or device kind changes
  it; a checkpoint of another build, a corrupt one or one that is not
  the request's becomes a counted clean restart at position 0.
* Batcher: `migrate_out` exports in-flight and queued requests
  (`MigratedError`), an idle drain exports nothing, `peek_checkpoints`
  leaves the request decoding, the beacon journals at its cadence.
"""

import json

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving.migrate import RequestCheckpoint as JRequestCheckpoint
from dalle_pytorch_tpu.serving.migrate import RowCheckpoint as JRowCheckpoint
from dalle_pytorch_tpu.serving.migrate import decode_checkpoint as j_decode
from dalle_pytorch_tpu.serving.migrate import encode_checkpoint as j_encode
from dalle_pytorch_tpu.utils.compile_cache import boot_fingerprint as j_boot_fingerprint
from dalle_pytorch_tpu.utils.compile_cache import pack_artifact as j_pack
from dalle_pytorch_tpu.utils.compile_cache import unpack_artifact as j_unpack
from dalle_pytorch_tpu_torch.serving import migrate as mig
from dalle_pytorch_tpu_torch.serving.batcher import ContinuousBatcher
from dalle_pytorch_tpu_torch.serving.engine import ContinuousEngine, SampleSpec
from dalle_pytorch_tpu_torch.serving.migrate import (
    CheckpointCorrupt,
    CheckpointMismatch,
    CheckpointSpool,
    MigratedError,
    RequestCheckpoint,
    RowCheckpoint,
    decode_checkpoint,
    encode_checkpoint,
    from_wire,
    to_wire,
)
from dalle_pytorch_tpu_torch.training.metrics import MetricsRegistry
from dalle_pytorch_tpu_torch.utils.artifact import boot_fingerprint, pack_artifact, unpack_artifact
from test_torch_dalle import TINY, _dalle_pair, _text
from test_torch_resume import _export, _hold_after

torch.set_num_threads(2)

TEXT_SEQ = TINY["text_seq_len"]
IMG_SEQ = TINY["image_fmap_size"] ** 2


def _cp(rows=None, **kw):
    if rows is None:
        rows = [RowCheckpoint(0, np.arange(TEXT_SEQ, dtype=np.int32), np.asarray([3, 1, 4], np.int32),
                              False, 7, 0.9, 0.8)]
    kw.setdefault("chunk_index", 5)
    kw.setdefault("site", "replica-a")
    kw.setdefault("request_key", "abc123")
    return RequestCheckpoint(rows=rows, **kw)


# ------------------------------------------------------------------ codec


def test_round_trip():
    cp = _cp(rows=[
        RowCheckpoint(0, np.arange(TEXT_SEQ, dtype=np.int32), np.arange(IMG_SEQ, dtype=np.int32), True, 11, 0.7, 0.95),
        RowCheckpoint(1, np.arange(TEXT_SEQ, dtype=np.int32), np.asarray([5, 9], np.int32), False, 12),
    ], tenant="t1", trace_id="deadbeefdeadbeef")
    blob = encode_checkpoint(cp, "fp-1")
    back = decode_checkpoint(blob, "fp-1")
    assert back.rows[0].done and back.rows[0].pos == IMG_SEQ
    assert back.rows[1].pos == 2 and not back.rows[1].done
    np.testing.assert_array_equal(back.rows[0].tokens, np.arange(IMG_SEQ))
    np.testing.assert_array_equal(back.rows[1].prompt_ids, np.arange(TEXT_SEQ))
    assert (back.rows[1].seed, back.rows[0].temperature, back.rows[0].top_k) == (12, 0.7, 0.95)
    assert (back.chunk_index, back.site, back.tenant, back.request_key) == (5, "replica-a", "t1", "abc123")
    assert back.trace_id == "deadbeefdeadbeef" and back.done_tokens() == IMG_SEQ
    assert from_wire(to_wire(blob)) == blob


def test_fingerprint_mismatch_raises_mismatch():
    with pytest.raises(CheckpointMismatch):
        decode_checkpoint(encode_checkpoint(_cp(), "fp-build-1"), "fp-build-2")


def test_truncated_and_garbled_raise_corrupt():
    blob = encode_checkpoint(_cp(), "fp")
    garbled = bytearray(blob)
    garbled[-5] ^= 0xFF
    for bad in (blob[:-3], bytes(garbled), b"NOTMAGIC" + blob, blob[: len(mig.CKPT_MAGIC) + 4]):
        with pytest.raises(CheckpointCorrupt):
            decode_checkpoint(bad, "fp")
    with pytest.raises(CheckpointCorrupt):
        decode_checkpoint("not bytes", "fp")
    with pytest.raises(CheckpointCorrupt):
        from_wire("!!! not base64 !!!")


def test_format_drift_is_mismatch_not_corrupt():
    blob = encode_checkpoint(_cp(), "fp")
    rest = blob[len(mig.CKPT_MAGIC):]
    nl = rest.index(b"\n")
    header = json.loads(rest[:nl])
    header["format"] = mig.CKPT_FORMAT + 1
    blob2 = mig.CKPT_MAGIC + json.dumps(header, sort_keys=True, separators=(",", ":")).encode() + b"\n" + rest[nl + 1:]
    with pytest.raises(CheckpointMismatch):
        decode_checkpoint(blob2, "fp")


# ------------------------------------------------------- across packages


def _both(cls_row, cls_req):
    rows = [
        cls_row(0, np.arange(TEXT_SEQ, dtype=np.int32), np.arange(IMG_SEQ, dtype=np.int32), True, 11, 0.7, 0.95),
        cls_row(1, np.arange(TEXT_SEQ, dtype=np.int32) + 1, np.asarray([5, 9, 2], np.int32), False, 12),
    ]
    return cls_req(rows=rows, chunk_index=3, tenant="t", trace_id="ab", site="s", request_key="k")


@pytest.mark.parametrize("fp", ["shared-fingerprint", "0123456789abcdef0123456789abcdef"])
def test_blobs_open_across_packages(fp):
    ours, theirs = encode_checkpoint(_both(RowCheckpoint, RequestCheckpoint), fp), j_encode(
        _both(JRowCheckpoint, JRequestCheckpoint), fp
    )
    assert ours == theirs
    for blob, decode in ((theirs, decode_checkpoint), (ours, j_decode)):
        back = decode(blob, fp)
        assert [r.pos for r in back.rows] == [IMG_SEQ, 3] and back.rows[1].seed == 12
        np.testing.assert_array_equal(back.rows[1].prompt_ids, np.arange(TEXT_SEQ) + 1)
    with pytest.raises(CheckpointMismatch):
        decode_checkpoint(theirs, fp + "-other")


def test_artifact_container_and_fingerprint_payload_match_the_reference():
    payload = b'{"a":1}'
    for magic in (b"DALLEAOT\n", mig.CKPT_MAGIC):
        blob = pack_artifact(magic, "fp", payload, extra={"x": 2})
        assert blob == j_pack(magic, "fp", payload, extra={"x": 2})
        assert unpack_artifact(blob, magic, "fp") == j_unpack(blob, magic, "fp") == ("hit", None, payload)
        assert unpack_artifact(blob, magic, "other")[0] == "miss"
        assert unpack_artifact(blob[:-1], magic, "fp") == ("reject", "truncated payload", None)
    # the same canonical hashing: the reference's payload with jax's
    # version and backend in place of torch's and the device kind
    cfg = {"model": {"dim": 64}}
    ours = boot_fingerprint(device="cpu", model_config=cfg, programs=("b", "a"), torch_version="9")
    assert len(ours) == 32
    assert ours == boot_fingerprint(device="cpu", model_config=cfg, programs=("a", "b"), torch_version="9")
    assert ours != j_boot_fingerprint(backend="cpu", model_config=cfg, programs=("a", "b"), jax_version="9")


# ------------------------------------------------------------------ spool


def test_spool_write_read_clear(tmp_path):
    spool = CheckpointSpool(tmp_path)
    blob = encode_checkpoint(_cp(), "fp")
    spool.write({"k1": blob, "k2": blob})
    assert spool.read() == {"k1": blob, "k2": blob}
    spool.write({"k3": blob})  # latest state only
    assert set(spool.read()) == {"k3"}
    spool.clear()
    assert spool.read() == {} and spool.writes == 2


def test_spool_skips_a_torn_entry(tmp_path):
    spool = CheckpointSpool(tmp_path)
    blob = encode_checkpoint(_cp(), "fp")
    spool.write({"k1": blob, "k2": blob})
    raw = spool.path.read_bytes()
    spool.path.write_bytes(raw[: len(raw) - 40])  # a torn write of the last line
    assert spool.read() == {"k1": blob} and spool.skipped_lines == 1

    class Truncate:
        fired = False

        def on_artifact_load(self, kind, path):
            assert kind == "spool"
            path.write_bytes(path.read_bytes()[:30])  # only a torn first line
            self.fired = True

    spool.faults = Truncate()
    assert spool.read() == {} and spool.faults.fired and spool.skipped_lines == 2


def test_spool_byte_cap_drops_largest_first(tmp_path):
    small = encode_checkpoint(_cp(), "fp")
    big = encode_checkpoint(_cp(rows=[
        RowCheckpoint(0, np.arange(TEXT_SEQ, dtype=np.int32), np.zeros(IMG_SEQ, np.int32), True, 1)
        for _ in range(64)
    ]), "fp")
    spool = CheckpointSpool(tmp_path, max_bytes=3 * len(to_wire(small)) + 256)
    spool.write({"small": small, "big": big})
    kept = spool.read()
    assert "small" in kept and "big" not in kept and spool.dropped_entries == 1
    assert spool.detail()["dropped_entries"] == 1


def test_metrics_registry_renders_the_counters():
    reg = MetricsRegistry()
    reg.counter("dalle_serving_decoded_tokens_total", "decoded").inc(3)
    reg.counter_family("dalle_serving_resume_rejects_total", "rejects", label_name="reason").labels("corrupt").inc()
    reg.histogram("dalle_serving_chunk_seconds", "chunk wall").observe(0.02)
    text = reg.render()
    assert "dalle_serving_decoded_tokens_total 3" in text
    assert 'dalle_serving_resume_rejects_total{reason="corrupt"} 1' in text
    assert 'dalle_serving_chunk_seconds_bucket{le="0.025"} 1' in text
    assert reg.counter("dalle_serving_decoded_tokens_total") is reg.get("dalle_serving_decoded_tokens_total")
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("dalle_serving_decoded_tokens_total")


# ---------------------------------------------------- engines and batcher


@pytest.fixture(scope="module")
def pm():
    return _dalle_pair(seed=31, shift_tokens=True, rotary_emb=True)[2]


def _engine(pm, max_batch=2, **kw):
    return ContinuousEngine(
        pm, max_batch=max_batch, chunk_tokens=2, prefill_batch=max_batch, device="cpu",
        resume_enabled=True, **kw,
    )


def _specs(n, seed):
    texts = _text(n, seed=seed)
    return [SampleSpec(texts[i], seed=seed + i, top_k=0.5) for i in range(n)]


def test_fingerprints_agree_on_one_build_and_split_on_any_change(pm, monkeypatch):
    import copy

    a, b = _engine(pm), _engine(pm)
    fp = a.resume_fingerprint()
    assert fp == b.resume_fingerprint()
    assert _engine(pm, kv_dtype="int8").resume_fingerprint() != fp  # model repr
    # the ladder: without a VAE no preview program exists to add
    assert _engine(pm, preview_enabled=True).resume_fingerprint() == fp
    assert ContinuousEngine(pm, max_batch=2, chunk_tokens=2, prefill_batch=2,
                            device="cpu").resume_fingerprint() != fp
    wider = copy.copy(pm)
    wider.attn_impl = "dense"
    assert _engine(wider).resume_fingerprint() != fp
    c = _engine(pm)
    c.cfg = {"model": {"dim": 64}}
    assert c.resume_fingerprint() != fp  # config
    import dalle_pytorch_tpu_torch.serving.engine as eng_mod

    monkeypatch.setattr(torch, "__version__", "0.0-other")
    assert _engine(pm).resume_fingerprint() != fp  # torch version
    monkeypatch.undo()
    monkeypatch.setattr(eng_mod, "device_kind", lambda device: "NVIDIA H100 80GB HBM3")
    assert _engine(pm).resume_fingerprint() != fp  # device kind


@pytest.mark.parametrize("reason", ["mismatch", "corrupt", "inconsistent"])
def test_a_bad_resume_is_a_counted_clean_restart(pm, reason):
    specs = _specs(1, seed=50)
    eng = _engine(pm)
    b = ContinuousBatcher(eng)
    try:
        ref, _ = b.submit(specs).future.result(60)
        cp = RequestCheckpoint(rows=[RowCheckpoint(0, specs[0].text_ids, ref[0][:3], False, 50, 1.0, 0.5)])
        wire = to_wire(encode_checkpoint(cp, b.checkpoint_fingerprint))
        if reason == "mismatch":
            wire = to_wire(encode_checkpoint(cp, "some-other-build"))
        elif reason == "corrupt":
            wire = to_wire(b"NOTMAGIC" + from_wire(wire))
        asked = specs if reason != "inconsistent" else _specs(1, seed=51)
        got, size = b.validate_resume(wire, asked)
        assert got is None and size is None
        toks, _ = b.submit(asked).future.result(60)  # served from position 0
        if reason != "inconsistent":
            np.testing.assert_array_equal(toks, ref)
    finally:
        b.shutdown()
    counts = {label: int(c.value) for label, c in b.registry.get("dalle_serving_resume_rejects_total").items()}
    assert counts == {reason: 1}
    assert eng.stats.resume_dispatches == 0


def test_migrate_out_exports_inflight_and_queued(pm):
    eng = _engine(pm)
    reached, gate = _hold_after(eng, 3)
    b = ContinuousBatcher(eng)
    try:
        r1 = b.submit(_specs(2, seed=200), request_key="r1")
        assert reached.wait(30)
        assert b.inflight_rows == 2
        r2 = b.submit(_specs(1, seed=300))  # no free slot: queued
        cps = _export(b, gate)
        assert cps is not None and len(cps) == 2
        for req in (r1, r2):
            with pytest.raises(MigratedError) as err:
                req.future.result(10)
            cp = err.value.checkpoint
            assert all(not row.done for row in cp.rows) and cp.encoded is not None
            assert decode_checkpoint(cp.encoded, b.checkpoint_fingerprint).rows[0].pos == cp.rows[0].pos
        live = next(cp for cp in cps if len(cp.rows) == 2)
        assert live.request_key == "r1" and all(row.pos == 6 for row in live.rows)
        assert live.chunk_index == 3 and live.reason == "drain"
        assert b.inflight_rows == 0 and int(b.registry.get("dalle_serving_migrated_out_total").value) == 2
        toks, _ = b.submit(_specs(1, seed=400)).future.result(60)  # serves on
        assert toks.shape == (1, IMG_SEQ)
    finally:
        b.shutdown()


def test_idle_migrate_returns_empty(pm):
    b = ContinuousBatcher(_engine(pm))
    try:
        assert b.migrate_out(timeout_s=10) == []
    finally:
        b.shutdown()


def test_peek_checkpoints_is_nondestructive(pm):
    eng = _engine(pm)
    reached, gate = _hold_after(eng, 2)
    b = ContinuousBatcher(eng)
    try:
        req = b.submit(_specs(1, seed=500))
        assert reached.wait(30)
        cps = _export(b, gate, destructive=False)
        assert len(cps) == 1 and cps[0].rows[0].pos == 4
        toks, _ = req.future.result(60)  # decodes on to completion
        np.testing.assert_array_equal(toks[0, :4], cps[0].rows[0].tokens)
    finally:
        b.shutdown()


def test_beacon_journals_at_its_cadence(pm, tmp_path):
    spool = CheckpointSpool(tmp_path)
    eng = _engine(pm)
    b = ContinuousBatcher(eng, spool=spool, spool_every=2)
    journaled = []
    write = spool.write
    spool.write = lambda bundle: (journaled.append({k: decode_checkpoint(v, b.checkpoint_fingerprint)
                                                    for k, v in bundle.items()}), write(bundle))
    try:
        toks, _ = b.submit(_specs(1, seed=888), request_key="beacon-key").future.result(60)
    finally:
        b.shutdown()
    # 8 chunks of 2 tokens: a beacon after chunks 2, 4, 6 and 8
    assert spool.writes == 4 and b.last_beacon["chunk_index"] == 8
    positions = [bundle["beacon-key"].rows[0].pos for bundle in journaled[:3]]
    assert positions == [4, 8, 12]
    for bundle, pos in zip(journaled, positions):
        np.testing.assert_array_equal(bundle["beacon-key"].rows[0].tokens, toks[0, :pos])
        assert bundle["beacon-key"].reason == "beacon"
    # the last beacon came after the row retired: the journal is empty
    assert journaled[3] == {} and spool.read() == {} and b.last_beacon["checkpoints"] == {}
