"""The port's config reader against the JAX package's: ``compose`` gives the
same tree, values and types, for the defaults and for override lists; the
YAML-subset reader gives what ``yaml.safe_load`` gives on every file under
``configs/`` and on scalars; constructs outside the subset raise. Strings
and values exactly."""

import glob
import math
import os

import pytest
import yaml

from egopack_torch.config import compose, default_config_dir, instantiate
from egopack_torch.config import to_container
from egopack_torch.config.yaml_subset import YamlSubsetError, load, parse_scalar
from egopack_tpu.config import compose as jcompose
from egopack_tpu.config import default_config_dir as jdefault_config_dir
from egopack_tpu.config import to_container as jto_container

CONFIG_DIR = default_config_dir()
SKILL_PHASE1 = [
    "seed=1", "k=1", "num_epochs=7", "batch_size=4", "num_workers=0",
    "model.hidden_size=32", "model.temporal_pooling.hidden_size=32",
    "oscc_feat_size=32", "save_model=True", "enabled_tasks=[ar,lta,pnr]",
    "validation_split=val", "dataset_recognition.root=/tmp/vr/ego4d",
    "dataset_oscc.root=/tmp/vr/ego4d", "dataset_lta.root=/tmp/vr/ego4d",
    "dataset_pnr.root=/tmp/vr/ego4d", "artifact_dir=/tmp/vr/artifacts",
    "output_dir=/tmp/vr/outputs", "parallel.data=1"]
OVERRIDES = {
    "defaults": [],
    "skill_phase1": SKILL_PHASE1,
    "group_trn": ["model/temporal_pooling=trn",
                  "model.temporal_pooling.dropout=0.5"],
    "tasks": ["enabled_tasks=[ar,lta,pnr]", "weight_lta=0.5"],
    "lr": ["optimizer.lr=3e-4", "optimizer.impl=fused",
           "optimizer.weight_decay=1.0e-5"],
    "new_key": ["+new_key=1", "+extra.nested='a b'", "+flag=yes"],
    "interpolation": ["num_epochs=12", "+epochs_copy=${num_epochs}",
                      "+name_with=run_${seed}_${k}"],
    "group_model": ["model=graph", "model.depth=2", "device=cpu",
                    "checkpoint.enable=True", "profile_dir=null"],
}
SCALARS = ["1e-5", "1.0e-5", "True", "yes", "null", "~", "-1", "0x10",
           "'a b'", "[a, b]", "017", "1_000", "-.inf", ".5", "off", "",
           '"x\\ty"', "[ar, 'l t a', 3]", "1.0e5", "${num_epochs}"]


def same(a, b, path="cfg"):
    """Equal values of equal types, recursively (``True == 1`` is not
    enough)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def test_config_dir_is_the_repositorys():
    assert os.path.samefile(CONFIG_DIR, jdefault_config_dir())


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_compose_matches_jax(name):
    ours = compose(CONFIG_DIR, "defaults", OVERRIDES[name])
    ref = jcompose(CONFIG_DIR, "defaults", OVERRIDES[name])
    same(to_container(ours), jto_container(ref))
    assert isinstance(ours.optimizer.lr, float)
    assert ours.model.temporal_pooling.hidden_size == \
        ref.model.temporal_pooling.hidden_size


def test_lr_and_interpolation_types():
    cfg = compose(CONFIG_DIR, "defaults",
                  ["num_epochs=12", "+epochs_copy=${num_epochs}"])
    assert cfg.optimizer.lr == 1e-05 and type(cfg.optimizer.lr) is float
    assert cfg.lr_scheduler.T_max == 12 and cfg["epochs_copy"] == 12


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True)))
def test_yaml_subset_matches_safe_load_on_configs(path):
    with open(path) as f:
        text = f.read()
    same(load(text, path), yaml.safe_load(text))


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_subset_types_scalars_as_safe_load(text):
    same(parse_scalar(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: {b: 1}\n", "a: &x 1\nb: *x\n", "a: |\n  text\n", "a: b\n  c\n",
    "1: one\n", "---\na: 1\n", "a: !!str 1\n", "a: 2001-12-14\n",
    "a: [b, [c]]\n", "a: b: c\n"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(YamlSubsetError):
        load(text)


def test_override_outside_the_subset_raises():
    with pytest.raises(YamlSubsetError):
        compose(CONFIG_DIR, "defaults", ["+bad={a: 1}"])


def test_unknown_jax_target_raises_without_import():
    with pytest.raises(ValueError, match="no counterpart"):
        instantiate({"_target_": "egopack_tpu.models.graphone.GraphONE"})


def test_targets_map_to_port_callables():
    from egopack_torch.models.backbone import TemporalGraph
    from egopack_torch.models.pooling import TRNPooling
    cfg = compose(CONFIG_DIR, "defaults",
                  ["model.hidden_size=8", "model.temporal_pooling.hidden_size=8",
                   "model.depth=2"])
    backbone = instantiate(cfg.model, _recursive_=False, input_size=4,
                           num_segments=3, device="cpu")
    assert isinstance(backbone, TemporalGraph) and backbone.depth == 2
    assert isinstance(backbone.pooling, TRNPooling)
    assert backbone.pooling.dropout == 0.5
    assert backbone.pooling.fc0.weight.shape == (8, 12)
    opt = instantiate(cfg.optimizer)
    assert type(opt).__module__ == "egopack_torch.train.optim"
    assert opt.lr == 1e-05 and opt.impl == "optax"
    sched = instantiate(cfg.lr_scheduler)
    assert sched(0, 1.0) == 1.0
