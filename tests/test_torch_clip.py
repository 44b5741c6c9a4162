"""The port's CLIP vs the JAX package's (CPU).

The same weights (a JAX init carried across by `weights.load_clip_params`)
and the same numpy text, mask and images go through both: per-pair scores
and the contrastive loss within 1e-5, with and without a text mask, with
the encoders' attention dense and through the flash arm (both packages'
"auto" threshold lowered so the unmasked encoders take the non-causal
flash-attention arm: the JAX side runs its Pallas kernel in interpret
mode, the port its plain version; a masked text encoder stays dense, as
the reference chooses); rerank orders identical; and the checkpoint format
read both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import attention as jattention
from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.models.clip import rerank as jrerank
from dalle_pytorch_tpu.training.pipeline import load_clip_checkpoint as j_load_clip
from dalle_pytorch_tpu.training.pipeline import save_clip_checkpoint as j_save_clip
from dalle_pytorch_tpu_torch.models import attention as pattention
from dalle_pytorch_tpu_torch.models.clip import CLIP, rerank
from dalle_pytorch_tpu_torch.training.pipeline import load_clip_checkpoint, save_clip_checkpoint
from dalle_pytorch_tpu_torch.weights import export_clip_params, load_clip_params

torch.set_num_threads(2)

TINY_CLIP = dict(
    dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=60, text_enc_depth=2,
    text_seq_len=8, text_heads=2, visual_enc_depth=2, visual_heads=2,
    visual_image_size=32, visual_patch_size=8,
)


@pytest.fixture(scope="module")
def pair():
    jc = JCLIP(**TINY_CLIP)
    rng = np.random.RandomState(0)
    text = rng.randint(1, TINY_CLIP["num_text_tokens"], (4, 8)).astype(np.int32)
    text[0, 5:] = 0
    text[2, 3:] = 0
    images = rng.rand(4, 32, 32, 3).astype(np.float32)
    params = jc.init(jax.random.PRNGKey(1), jnp.asarray(text), jnp.asarray(images))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # a temperature away from the init's 1, so its exp is tested
    params = {**params, "temperature": np.asarray(0.7, np.float32)}
    port = load_clip_params(CLIP(**TINY_CLIP), params).eval()
    return jc, params, port, text, images


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "text_mask"])
def test_scores_and_loss_match_the_reference(pair, monkeypatch, attn, masked):
    jc, params, port, text, images = pair
    if attn == "flash":  # both packages' encoders take the flash arm from 1 token
        monkeypatch.setattr(jattention, "AUTO_FLASH_MIN_SEQ", 1)
        monkeypatch.setattr(pattention, "AUTO_FLASH_MIN_SEQ", 1)
    mask = text != 0 if masked else None
    jargs = dict(text_mask=None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        for loss in (False, True):
            ref = jc.apply({"params": params}, jnp.asarray(text), jnp.asarray(images),
                           return_loss=loss, **jargs)
            out = port(torch.from_numpy(text), torch.from_numpy(images), text_mask=tmask,
                       return_loss=loss)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_the_flash_arm_runs_without_a_mask(monkeypatch):
    """Under the lowered threshold the unmasked encoders call the flash
    attention wrapper non-causally; a text mask keeps the text encoder
    dense."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention

    def spy(q, k, v, mask=None, causal=True, sm_scale=None):
        calls.append(causal)
        return real(q, k, v, mask, causal, sm_scale)

    monkeypatch.setattr(pattention, "AUTO_FLASH_MIN_SEQ", 1)
    monkeypatch.setattr(pattention, "flash_attention", spy)
    clip = CLIP(**TINY_CLIP).eval()
    text = torch.randint(1, 60, (2, 8))
    images = torch.rand(2, 32, 32, 3)
    with torch.inference_mode():
        clip(text, images)
        assert calls == [False] * 4  # two layers in each encoder
        calls.clear()
        clip(text, images, text_mask=text != 0)
        assert calls == [False] * 2  # the image encoder's only


def test_rerank_order_matches_the_reference(pair):
    jc, params, port, text, images = pair
    rng = np.random.RandomState(5)
    many = rng.rand(6, 32, 32, 3).astype(np.float32)
    prompt = text[:1]
    mask = prompt != 0
    j_imgs, j_scores, j_order = jrerank(jc, {"params": params}, jnp.asarray(prompt),
                                        jnp.asarray(many), text_mask=jnp.asarray(mask))
    p_imgs, p_scores, p_order = rerank(port, torch.from_numpy(prompt), torch.from_numpy(many),
                                       text_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(p_order.numpy(), np.asarray(j_order))
    np.testing.assert_allclose(p_scores.numpy(), np.asarray(j_scores), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p_imgs.numpy(), np.asarray(j_imgs))
    assert (np.diff(p_scores.numpy()) <= 0).all()


def test_checkpoints_read_both_ways(pair, tmp_path):
    jc, params, port, text, images = pair
    exported = export_clip_params(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(exported))
    assert len(flat_ref) == len(flat_out)
    for path, leaf in flat_ref:
        assert flat_out[path].shape == leaf.shape, path
        np.testing.assert_array_equal(flat_out[path], leaf)
    # the port's checkpoint in the reference, and the reference's in the port
    save_clip_checkpoint(str(tmp_path / "port.npz"), port)
    jc2, jparams = j_load_clip(str(tmp_path / "port.npz"))
    j_save_clip(str(tmp_path / "jax.npz"), jc, params)
    port2 = load_clip_checkpoint(str(tmp_path / "jax.npz")).eval()
    ref = jc2.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(images))
    with torch.inference_mode():
        out = port2(torch.from_numpy(text), torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
