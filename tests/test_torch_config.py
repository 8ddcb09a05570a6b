"""The port's config reader and writer (speech2lip_tpu_torch.config) against
the JAX package's ``load_config`` on the CPU: every committed config, every
text ``yaml.safe_dump`` writes and every YAML form the configs may use
loads to the same tree in both packages, or raises in both; a config the
port writes is ``yaml.safe_dump``'s text and loads back to itself in both
readers.
"""

from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from speech2lip_tpu.core import config as jconfig
from speech2lip_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*.yaml"))


def _load_both(path):
    """(port, JAX) results of ``load_config(path)``: the tree, or the
    exception's type when the reader raises."""
    out = []
    for reader in (tconfig, jconfig):
        try:
            out.append(reader.load_config(str(path)))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            out.append(type(e))
    return out


def _same_in_both(path):
    """The tree both readers give for ``path``; fails if they differ, and
    returns None when both raise."""
    ours, ref = _load_both(path)
    if isinstance(ours, type) or isinstance(ref, type):
        assert isinstance(ours, type) and isinstance(ref, type), (ours, ref)
        return None
    assert ours == ref
    return ours


def _text_in_both(tmp_path, text):
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    return _same_in_both(path)


def _merged(tree):
    cfg = jconfig.default_config()
    jconfig.update_recursive(cfg, tree)
    return cfg


def test_committed_configs_are_the_four_checked():
    assert CONFIGS == ["configs/default.yaml", "configs/may/may.yaml",
                       "configs/obama2/obama2.yaml",
                       "configs/obama_adnerf/obama_adnerf.yaml"]


@pytest.mark.parametrize("path", CONFIGS)
def test_committed_config_loads_as_jax(path):
    assert tconfig.load_config(str(ROOT / path)) == \
        jconfig.load_config(str(ROOT / path))


def test_default_trees_equal():
    assert tconfig.default_config() == jconfig.default_config()
    assert tconfig.DEFAULT_CONFIG is not tconfig.default_config()


@pytest.mark.parametrize("text", [
    "a: 1.0e-4\nb: 1e-4\nc: .5\nd: -3\ne: ~\nf: yes\ng:\nh: x:y\n",
    "# head\na:\n  b:\n    c: 1   # tail\n  d: off\ne: 3_000\nf: +2.5\n",
    "x: .inf\ny: -.Inf\nz: NULL\nw: dataset/may_face_crop_lip\nv: .jpg\n",
])
def test_subset_scalars_resolve_as_safe_load(tmp_path, text):
    assert _text_in_both(tmp_path, text) == _merged(yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "parallel:\n  mesh_shape: [2, 2]\n",
    "model:\n  skips: [4]\n"
    "training:\n  scheduler_milestones: [200000, 400000]\n",
    "a: []\nb: [x, 1.5, true, null, ~]\nc: [1,2]\nd: [ -3 , +4 ]  # tail\n",
])
def test_flow_sequences_resolve_as_safe_load(tmp_path, text):
    assert _text_in_both(tmp_path, text) == _merged(yaml.safe_load(text))


# the texts a reader of a YAML subset refused before the port read configs
# with yaml.safe_load: each now gives what the JAX reader gives
@pytest.mark.parametrize("text", [
    "a: [1, [2]]", "a:\n  b: [1, 2", "a: [1, , 2]", "a: [x: 1]",
    "a:\n  b: {c: 1}", "a:\n  - 1", "a: 'quoted'", 'a: "quoted"',
    "a: &anchor 1", "a: *alias", "a: |\n  block", "a: >\n  folded",
    "a: !!str 1", "---\na: 1", "a: 010", "a: 0x1f", "a: 1:30",
    "a: 2020-01-01", "a:\n\tb: 1", "a: 1\na: 2", "true: 1", "  a: 1",
    "a: b: c", "a: 1\n   b: 2", "just a scalar",
])
def test_former_subset_refusals_load_as_jax(tmp_path, text):
    _text_in_both(tmp_path, text)


@pytest.mark.parametrize("text,tree", [
    ('data:\n  path: "data/obama"\n', {"data": {"path": "data/obama"}}),
    ("data:\n  path: 'data/obama'\n", {"data": {"path": "data/obama"}}),
    ("model:\n  skips:\n  - 4\n  - 6\n", {"model": {"skips": [4, 6]}}),
    ("x: {a: 1, b: [1, 2]}\n", {"x": {"a": 1, "b": [1, 2]}}),
    ("training:\n  scheduler_milestones: [200000,\n    400000]\n",
     {"training": {"scheduler_milestones": [200000, 400000]}}),
    ("base: &b\n  seed: 3\ntraining: *b\nmodel:\n  skips: &s [1, 2]\n"
     "  other: *s\n",
     {"base": {"seed": 3}, "training": {"seed": 3},
      "model": {"skips": [1, 2], "other": [1, 2]}}),
    ("x: [[1, 2], [3]]\ny:\n- - 1\n  - 2\n- []\n",
     {"x": [[1, 2], [3]], "y": [[1, 2], []]}),
])
def test_yaml_forms_load_as_jax(tmp_path, text, tree):
    assert _text_in_both(tmp_path, text) == _merged(tree)


@pytest.mark.parametrize("text", [
    "- 1\n- 2\n", "just a scalar\n", "a: [1, 2\n", "a: *undefined\n",
    "a: 1\n  b: 2\n", "a: !!python/object:os.system x\n",
])
def test_malformed_or_non_mapping_raises_in_both(tmp_path, text):
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    ours, ref = _load_both(path)
    assert isinstance(ours, type) and isinstance(ref, type), (ours, ref)


def test_safe_dump_of_default_config_loads_as_jax(tmp_path):
    text = yaml.safe_dump(jconfig.default_config())
    assert "  skips:\n  - 4\n" in text
    assert _text_in_both(tmp_path, text) == jconfig.default_config()


def test_config_written_as_the_jax_pipeline_tool_loads_as_jax(tmp_path):
    """A config built and written as ``tools/full_pipeline_run.py`` builds
    and writes its training config."""
    root, crop = str(tmp_path / "identity"), 64
    cfg = jconfig.default_config()
    cfg["data"].update({
        "path": root, "width": 16, "height": 12, "face_img_focal": 81.25,
        "val_split_frames": 4,
    })
    cfg["model"].update({
        "canonical_depth_height": crop, "canonical_depth_width": crop,
        "canonical_depth_init_path": str(tmp_path / "identity" /
                                         "depth_face_canonical.npy"),
    })
    cfg["training"].update({
        "out_dir": str(tmp_path / "ckpts"), "batch_size": 2,
        "batch_rays": 0, "print_every": 1, "checkpoint_every": 6,
        "backup_every": 0, "visualize_every": 0, "validate_every": 6,
        "learning_rate": 5e-4,
    })
    cfg["training"]["compute_dtype"] = "bfloat16"
    path = tmp_path / "config.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert _same_in_both(path) == cfg
    ours = tmp_path / "ours.yaml"
    tconfig.save_config(str(ours), cfg)
    assert ours.read_bytes() == path.read_bytes()


def test_inherit_chain_with_block_sequences_and_quotes(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "base.yaml").write_text(
        "data:\n  path: \"data/may face\"\n  extension: '.png'\n"
        "model:\n  skips:\n  - 2\n  - 5\n"
        "training:\n  scheduler_milestones:\n    - 10\n    - 20\n")
    (tmp_path / "sub" / "child.yaml").write_text(
        "inherit_from: '../base.yaml'\nmodel:\n  net_depth: 6\n"
        "training:\n  scheduler_milestones: [30,\n    40]\n")
    ours = _same_in_both(tmp_path / "sub" / "child.yaml")
    assert ours["data"]["path"] == "data/may face"
    assert ours["data"]["extension"] == ".png"
    assert (ours["model"]["skips"], ours["model"]["net_depth"]) == ([2, 5], 6)
    assert ours["training"]["scheduler_milestones"] == [30, 40]


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
    path = tmp_path / "cfg.yaml"
    for skips in ([3], [[3]]):
        cfg["model"]["skips"] = skips
        tconfig.save_config(str(path), cfg)
        assert path.read_text() == yaml.safe_dump(cfg)
        assert "  mesh_shape:\n  - 2\n  - 2\n" in path.read_text()
        assert tconfig.load_config(str(path)) == cfg
        assert jconfig.load_config(str(path)) == cfg


_KEYS = st.text(st.characters(codec="utf-8",
                              exclude_categories=("Cs", "Cc")),
                min_size=1, max_size=8).filter(lambda k: k != "inherit_from")
_LEAVES = (st.none() | st.booleans() | st.integers()
           | st.floats(allow_nan=False, allow_infinity=False)
           | st.text(max_size=12))
_TREES = st.dictionaries(_KEYS, st.recursive(
    _LEAVES, lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(_KEYS, inner, max_size=4), max_leaves=12), max_size=6)


@pytest.mark.parametrize("flow", [False, True, None])
@settings(max_examples=60, deadline=None)
@given(tree=_TREES)
def test_random_trees_load_alike_in_both_readers(tmp_path_factory, flow, tree):
    """Random nested trees, dumped in block, flow and mixed style, load to
    the same tree in both readers, and to the tree merged on the
    defaults."""
    path = tmp_path_factory.mktemp("tree") / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(tree, f, default_flow_style=flow)
    assert _same_in_both(path) == _merged(tree)
