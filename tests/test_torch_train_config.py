"""The port's trainer configuration and learning-rate controllers vs the
JAX package's.

* `config_to_dict(load_config(yaml, overrides))` is the same dict in both
  packages for the same YAML file and `--set` list (exact), with each
  objective preset; an unknown key raises in both; a checkpoint config
  merges into either package's `TrainConfig` alike.
* Without PyYAML, the port's `--config` raises an ImportError naming it.
* `ReduceLROnPlateau` and `ExponentialDecay` give the same learning rates
  (exact) and `state_dict`s over one metric sequence, and each package
  continues from the other's state dict as from its own.
"""

import sys

import numpy as np
import pytest

from dalle_pytorch_tpu.training import config as jconfig
from dalle_pytorch_tpu.training import lr as jlr
from dalle_pytorch_tpu_torch.training import config as pconfig
from dalle_pytorch_tpu_torch.training import lr as plr

YAML = """
epochs: 3
batch_size: 8
learning_rate: 0.0001
lr_decay: true
keep_n_checkpoints: 2
model:
  dim: 256
  depth: 4
  attn_types: full,axial_row
  shared_attn_ids: 0,1,0,1
  rotary_emb: true
  attn_impl: flash
vae:
  image_size: 64
  num_layers: 2
mesh:
  fsdp: 1
"""

CASES = {
    "defaults": (False, []),
    "sets": (False, ["model.depth=2", "bf16=false", "save_every_n_steps=7", "null_cond_prob=0.2",
                     "keep_n_checkpoints=3", "vae_path=null", "model.shift_tokens=yes"]),
    "yaml": (True, []),
    "yaml+sets": (True, ["model.dim=128", "wandb_entity=team", "steps_per_dispatch=4"]),
    **{f"exp-{k}": (False, [f"exp={k}"]) for k in ("f", "ff", "r", "ro")},
    "yaml+exp-r": (True, ["exp=r", "mode=forward_only"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_config_dict_is_the_reference_dict(name, tmp_path):
    with_yaml, sets = CASES[name]
    path = None
    if with_yaml:
        path = tmp_path / "cfg.yaml"
        path.write_text(YAML)
        path = str(path)
    ref = jconfig.config_to_dict(jconfig.load_config(path, sets))
    ours = pconfig.config_to_dict(pconfig.load_config(path, sets))
    assert ours == ref
    assert ours["mode"] == ref["mode"]


@pytest.mark.parametrize("key", ["model.nope=1", "nope=1", "mesh.dp.x=1"])
def test_unknown_keys_raise_in_both(key):
    with pytest.raises((KeyError, AttributeError)) as ref:
        jconfig.load_config(None, [key])
    with pytest.raises(type(ref.value)):
        pconfig.load_config(None, [key])


def test_checkpoint_configs_merge_across_packages(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    sets = ["exp=ff", "model.depth=3"]
    jd = jconfig.config_to_dict(jconfig.load_config(str(path), sets))
    pd = pconfig.config_to_dict(pconfig.load_config(str(path), sets))
    assert pd == jd
    merged = {}
    for name, pkg in (("port", pconfig), ("ref", jconfig)):
        cfg = pkg.TrainConfig()
        pkg._merge_dict(cfg, jd)  # as `load_dalle_checkpoint` does
        merged[name] = pkg.config_to_dict(cfg)
    assert merged["port"] == merged["ref"]
    assert merged["port"]["model"] == jd["model"] and merged["port"]["mode"] == "forward_forward"


def test_yaml_config_without_pyyaml_names_it(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        pconfig.load_config(str(path))
    assert pconfig.load_config(None, ["epochs=2"]).epochs == 2


METRICS = [3.0, 2.5, 2.6, 2.7, 2.4, 2.9, 2.9, 3.1, 2.95, 2.41, 2.5, 2.6, 2.3, 2.35, 2.4,
           2.5, 2.6, 2.7, 2.8, 2.2]


@pytest.mark.parametrize("kind", ["plateau", "exponential"])
def test_lr_sequences_and_state_dicts_match(kind):
    if kind == "plateau":
        kw = dict(factor=0.5, patience=2, cooldown=1, min_lr=1e-3)
        ref, ours = jlr.ReduceLROnPlateau(**kw), plr.ReduceLROnPlateau(**kw)
    else:
        ref, ours = jlr.ExponentialDecay(gamma=0.9), plr.ExponentialDecay(gamma=0.9)
    lr_ref = lr_ours = 0.1
    for m in METRICS:
        lr_ref, lr_ours = ref.step(m, lr_ref), ours.step(m, lr_ours)
        assert lr_ours == lr_ref
        assert ours.state_dict() == ref.state_dict()
    if kind == "plateau":
        assert lr_ref < 0.1  # the sequence reduced it


@pytest.mark.parametrize("kind", ["plateau", "exponential"])
def test_lr_states_load_across_packages(kind):
    """Halfway through, each package loads the other's state dict and
    goes on as the one it came from."""
    make = {
        "plateau": lambda m: m.ReduceLROnPlateau(factor=0.5, patience=1, cooldown=2),
        "exponential": lambda m: m.ExponentialDecay(gamma=0.8),
    }[kind]
    ref, ours = make(jlr), make(plr)
    lr = 1.0
    for m in METRICS[:10]:
        lr = ref.step(m, lr)
        ours.step(m, lr)
    port_from_ref, ref_from_port = make(plr), make(jlr)
    port_from_ref.load_state_dict(ref.state_dict())
    ref_from_port.load_state_dict(ours.state_dict())
    a = b = c = lr
    for m in METRICS[10:]:
        a, b, c = ref.step(m, a), port_from_ref.step(m, b), ref_from_port.step(m, c)
        assert a == b == c
    assert np.isfinite(a)
