"""Port's GenerationEngine vs the JAX package's micro GenerationEngine (CPU).

Same weights, same prompts, greedy specs (`top_k=1.0` keeps one logit per
row, so the two packages' different noise sources cannot matter). Tokens
must be identical and pixels hold to 1e-5. Token identity is meaningful
only where the best two image logits are further apart than the logit
tolerance (1e-4, test_torch_dalle.py): the test asserts a gap of at least
1e-3 at every step of the JAX run, recomputed by teacher-forcing the JAX
model along its own tokens. The ladder (1, 3) puts two rows into the
3-row shape, so padding is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.serving.engine import GenerationEngine as JEngine
from dalle_pytorch_tpu.serving.engine import SampleSpec as JSpec
from dalle_pytorch_tpu.training.config import TrainConfig
from dalle_pytorch_tpu.training.pipeline import dvae_hparams, save_dalle_checkpoint
from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
from dalle_pytorch_tpu_torch.data.tokenizer import ByteTokenizer
from dalle_pytorch_tpu_torch.serving.engine import (
    GenerationEngine,
    SampleSpec,
    engine_from_checkpoint,
)
from test_torch_dalle import TINY, _dalle_pair, _vae_pair

torch.set_num_threads(2)

MODEL = dict(num_text_tokens=257, attn_types=("full",), shift_tokens=True, rotary_emb=True)
SHAPES = (1, 3)
MIN_GAP = 1e-3


def _prompts():
    tok = ByteTokenizer()
    return [
        tok.tokenize(p, TINY["text_seq_len"], truncate_text=True)[0]
        for p in ("a red cube", "blue sky", "tiny")
    ]


@pytest.fixture(scope="module")
def setup():
    jm, variables, pm = _dalle_pair(seed=11, **MODEL)
    jv, vparams, pv = _vae_pair(seed=12)
    jeng = JEngine(jm, variables, vae=jv, vae_params=vparams["params"], batch_shapes=SHAPES)
    peng = GenerationEngine(pm, pv, batch_shapes=SHAPES, device="cpu")
    prompts = _prompts()
    greedy = [(p, dict(seed=s, temperature=1.0, top_k=1.0)) for p, s in zip(prompts, (3, 5, 8))]
    jax_runs = [
        jeng.generate([JSpec(p, **kw) for p, kw in greedy[:1]]),
        jeng.generate([JSpec(p, **kw) for p, kw in greedy[1:]]),
    ]
    return dict(
        jm=jm, variables=variables, jv=jv, vparams=vparams, peng=peng,
        greedy=greedy, jax_runs=jax_runs,
    )


def _jax_image_logit_gaps(jm, variables, text, tokens):
    """Top-2 gap of the image-vocab logits at every step of a JAX run,
    teacher-forced along that run's tokens (batch of one row)."""
    prefill = jax.jit(lambda v, t, c: jm.apply(v, t, c, method=JDALLE.decode_prefill))
    step = jax.jit(lambda v, tok, i, c: jm.apply(v, tok, i, c, method=JDALLE.decode_image_step))
    row, cache = prefill(variables, jnp.asarray(text[None]), j_init_cache(jm, 1))
    gaps, argmaxes = [], []
    for i, tok in enumerate(tokens):
        img = np.asarray(row)[0, jm.total_text_tokens :]
        top2 = np.sort(img)[-2:]
        gaps.append(top2[1] - top2[0])
        argmaxes.append(int(np.argmax(img)))
        row, cache = step(variables, jnp.asarray([tok], jnp.int32), jnp.int32(i), cache)
    return np.array(gaps), argmaxes


def test_greedy_tokens_identical_to_reference(setup):
    peng, greedy = setup["peng"], setup["greedy"]
    port_runs = [
        peng.generate([SampleSpec(p, **kw) for p, kw in greedy[:1]]),
        peng.generate([SampleSpec(p, **kw) for p, kw in greedy[1:]]),
    ]
    assert peng.stats.rows_padded == 1
    j_tokens = np.concatenate([t for t, _ in setup["jax_runs"]])
    for (p, _), toks in zip(greedy, j_tokens):
        gaps, argmaxes = _jax_image_logit_gaps(setup["jm"], setup["variables"], p, toks)
        assert argmaxes == list(toks)
        assert gaps.min() >= MIN_GAP, f"greedy identity not meaningful: gap {gaps.min()}"
    for (jt, jp), (pt, pp) in zip(setup["jax_runs"], port_runs):
        assert pt.dtype == np.int32 and pt.shape == jt.shape
        np.testing.assert_array_equal(pt, jt)
        assert pp.shape == jp.shape == (len(pt), 32, 32, 3)
        np.testing.assert_allclose(pp, jp, atol=1e-5, rtol=0)


def test_sampled_tokens_do_not_depend_on_the_batch(setup):
    peng = setup["peng"]
    p0, p1 = _prompts()[:2]
    spec = SampleSpec(p0, seed=21, temperature=1.0, top_k=0.9)
    alone, _ = peng.generate([spec])
    padded, _ = peng.generate([SampleSpec(p1, seed=4, temperature=1.0, top_k=0.9), spec])
    np.testing.assert_array_equal(alone[0], padded[1])
    other, _ = peng.generate([SampleSpec(p0, seed=22, temperature=1.0, top_k=0.9)])
    assert not np.array_equal(alone[0], other[0])


def _byte_default_vocabulary(monkeypatch):
    """A machine whose default vocabulary cannot load (no C++ toolchain):
    the port's default probe falls back to the byte tokenizer, the
    vocabulary this checkpoint was trained with."""
    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    monkeypatch.setattr(port_tokenizer, "_default_decision", None)
    monkeypatch.setattr(port_tokenizer, "_warned_default_probe", True)


def test_checkpoint_read_by_the_port(setup, tmp_path, monkeypatch):
    cfg = TrainConfig()
    for key, val in dict(
        dim=TINY["dim"], depth=TINY["depth"], heads=TINY["heads"],
        dim_head=TINY["dim_head"], text_seq_len=TINY["text_seq_len"],
        attn_types="full", shift_tokens=True, rotary_emb=True, attn_impl="flash",
    ).items():
        setattr(cfg.model, key, val)
    cfg.bf16 = False
    path = tmp_path / "dalle.npz"
    save_dalle_checkpoint(
        str(path), cfg, setup["variables"]["params"], setup["vparams"]["params"],
        epoch=0, vae_class_name="DiscreteVAE", vae_hparams=dvae_hparams(setup["jv"]),
    )
    _byte_default_vocabulary(monkeypatch)
    eng = engine_from_checkpoint(str(path), batch_shapes=(1,), device="cpu")
    assert isinstance(eng.tokenizer, ByteTokenizer)
    assert eng.model.dtype == torch.float32
    p, kw = setup["greedy"][0]
    np.testing.assert_array_equal(eng.tokenize("a red cube"), p)
    toks, pixels = eng.generate([SampleSpec(p, **kw)])
    np.testing.assert_array_equal(toks, setup["jax_runs"][0][0])
    np.testing.assert_allclose(pixels, setup["jax_runs"][0][1], atol=1e-5, rtol=0)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            engine_from_checkpoint(str(path))


def test_entry_points_default_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        GenerationEngine(setup["peng"].model)
