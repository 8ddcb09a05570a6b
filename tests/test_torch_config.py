"""The port's yaml-free config reader (speech2lip_tpu_torch.config) against
the JAX package's ``load_config`` (yaml.safe_load) on the CPU: every
committed config loads to the same tree, the default trees are equal, the
subset's scalars and flow sequences resolve as ``yaml.safe_load``
resolves them, YAML outside the subset raises with its line number, and a
config the port writes (a ``[2, 2]`` mesh and other lists included) loads
back to itself in both readers.
"""

from pathlib import Path

import pytest
import yaml

from speech2lip_tpu.core import config as jconfig
from speech2lip_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*.yaml"))


def test_committed_configs_are_the_four_checked():
    assert CONFIGS == ["configs/default.yaml", "configs/may/may.yaml",
                       "configs/obama2/obama2.yaml",
                       "configs/obama_adnerf/obama_adnerf.yaml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_committed_config_loads_as_jax(path):
    ours = tconfig.load_config(str(ROOT / path))
    ref = jconfig.load_config(str(ROOT / path))
    assert ours == ref
    # and the raw file parses as yaml.safe_load parses it
    text = (ROOT / path).read_text()
    assert tconfig.parse_yaml(text, path) == yaml.safe_load(text)


def test_default_trees_equal():
    assert tconfig.default_config() == jconfig.default_config()
    assert tconfig.DEFAULT_CONFIG is not tconfig.default_config()


@pytest.mark.parametrize("text", [
    "a: 1.0e-4\nb: 1e-4\nc: .5\nd: -3\ne: ~\nf: yes\ng:\nh: x:y\n",
    "# head\na:\n  b:\n    c: 1   # tail\n  d: off\ne: 3_000\nf: +2.5\n",
    "x: .inf\ny: -.Inf\nz: NULL\nw: dataset/may_face_crop_lip\nv: .jpg\n",
])
def test_subset_scalars_resolve_as_safe_load(text):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "parallel:\n  mesh_shape: [2, 2]\n",
    "model:\n  skips: [4]\n"
    "training:\n  scheduler_milestones: [200000, 400000]\n",
    "a: []\nb: [x, 1.5, true, null, ~]\nc: [1,2]\nd: [ -3 , +4 ]  # tail\n",
])
def test_flow_sequences_resolve_as_safe_load(text):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,line", [
    ("a: [1, [2]]", 1), ("a:\n  b: [1, 2", 2), ("a: [1, , 2]", 1),
    ("a: [x: 1]", 1), ("a:\n  b: {c: 1}", 2), ("a:\n  - 1", 2),
    ("a: 'quoted'", 1), ('a: "quoted"', 1), ("a: &anchor 1", 1),
    ("a: *alias", 1), ("a: |\n  block", 1), ("a: >\n  folded", 1),
    ("a: !!str 1", 1), ("---\na: 1", 1), ("a: 010", 1), ("a: 0x1f", 1),
    ("a: 1:30", 1), ("a: 2020-01-01", 1), ("a:\n\tb: 1", 2),
    ("a: 1\na: 2", 2), ("true: 1", 1), ("  a: 1", 1), ("a: b: c", 1),
    ("a: 1\n   b: 2", 2), ("just a scalar", 1),
])
def test_outside_subset_raises_with_its_line(text, line):
    with pytest.raises(tconfig.YamlSubsetError, match=f":{line}: "):
        tconfig.parse_yaml(text)


def test_inherit_chain_and_depth_guard(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "base.yaml").write_text(
        "training:\n  seed: 7\n  batch_size: 4\n")
    (tmp_path / "sub" / "child.yaml").write_text(
        "inherit_from: ../base.yaml\ntraining:\n  batch_size: 2\n"
        "data:\n  path: somewhere\n")
    child = str(tmp_path / "sub" / "child.yaml")
    ours = tconfig.load_config(child)
    assert ours == jconfig.load_config(child)
    assert (ours["training"]["seed"], ours["training"]["batch_size"],
            ours["data"]["path"]) == (7, 2, "somewhere")
    loop = tmp_path / "loop.yaml"
    loop.write_text("inherit_from: loop.yaml\n")
    with pytest.raises(RecursionError):
        tconfig.load_config(str(loop))


def test_saved_config_loads_back_in_both_readers(tmp_path):
    cfg = tconfig.default_config()
    cfg["data"].update(path=str(tmp_path / "tree"), width=24, height=16,
                       face_img_focal=128.0)
    cfg["training"].update(learning_rate=1e-5, batch_size=8,
                           compute_dtype="bfloat16", pallas_gather="auto",
                           sync_start_iter=3, w_syncloss=0.5)
    cfg["model"].update(use_post_fusion_blackaug=False,
                        canonical_depth_init_path=None)
    cfg["parallel"]["mesh_shape"] = [2, 2]
    cfg["model"]["skips"] = [3]
    cfg["training"]["scheduler_milestones"] = []
    path = str(tmp_path / "cfg.yaml")
    tconfig.save_config(path, cfg)
    assert "mesh_shape: [2, 2]" in open(path).read()
    assert tconfig.load_config(path) == cfg
    assert jconfig.load_config(path) == cfg
    # lists are flow sequences of plain scalars, and nothing more
    cfg["model"]["skips"] = [[3]]
    with pytest.raises(tconfig.YamlSubsetError):
        tconfig.save_config(path, cfg)
