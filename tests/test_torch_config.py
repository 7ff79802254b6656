"""The port's YAML reader (rot_mvgaze_tpu_torch.utils.config.load_yaml)
against yaml.safe_load on the repository's subject lists and on
data_path.yaml variants, its refusals outside the subset, and
build_model_from_cfg against the JAX package's."""

import glob
import math
import os

import pytest
import yaml

from rot_mvgaze_tpu.models import FeatRotationSymm as JaxFeatRotationSymm
from rot_mvgaze_tpu.utils.config import build_model_from_cfg as jax_build_model_from_cfg
from rot_mvgaze_tpu_torch.models import FeatRotationSymm
from rot_mvgaze_tpu_torch.utils.config import build_model_from_cfg, load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECT_FILES = sorted(glob.glob(os.path.join(REPO, "configs", "subject", "*.yaml")))

# data_path.yaml as users write it, and the other forms of the subset
VARIANTS = {
    "plain": "xgaze: /data/xgaze\nmpiinv: /data/mpiinv\n",
    "quoted": "xgaze: '/data/eth xgaze'\nmpiinv: \"/data/mpii nv # not a comment\"\n",
    "single_quote_escape": "xgaze: 'it''s here'\nmpiinv: \"it's 'there'\"\n",
    "comments_and_blank_lines": "# dataset roots\n\nxgaze: /data/xgaze  # ETH\n\n   # indented\nmpiinv: /d/m#1\n",
    "null_forms": "xgaze: ~\nmpiinv:\nother: null\nlast: NULL\n",
    "windows_path": "xgaze: C:\\data\\xgaze\nmpiinv: D:/mpiinv\n",
    "scalars": "a: 1\nb: -0\nc: +7\nd: 1.5\ne: 1.\nf: .5\ng: 1.0e+3\nh: 1e5\ni: 1.0e5\nj: yes\n"
               "k: Off\nl: -.5\nm: .inf\nn: -.Inf\no: TRUE\np: 'true'\nq: x:y\nr: -x\n",
    "nested": "a:\n  b:\n    c: 1\n  d: two\ne: 3\n",
    "lists": "subject:\n  - p00.h5\n  - 'p01.h5'\n  -   p02.h5   # c\nflat:\n- 1\n- 2.5\n- ~\n",
    "model_config": "type: rot_mvgaze_tpu.models.FeatRotationSymm\nparams:\n  backbone_depth: 18\n"
                    "  num_iter: 2\n",
    "empty_params": "type: x\nparams:\n",
    "crlf_and_bom": "\ufeffxgaze: /x\r\nmpiinv: /y\r\n",
    "nan": "a: .nan\n",
}

# outside the subset: load_yaml raises, naming the line, and never guesses
REFUSED = {
    "flow_mapping": ("a: {b: 1}\n", 1),
    "flow_sequence": ("a:\n  b: [1, 2]\n", 2),
    "anchor": ("a: &x 1\nb: 2\n", 1),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "literal_block": ("a: |\n  text\n", 1),
    "folded_block": ("a: >\n  text\n", 1),
    "multi_line_plain": ("a: first\n  second\n", 2),
    "multi_line_quoted": ("a: 'first\n  second'\n", 1),
    "document_marker": ("---\na: 1\n", 1),
    "duplicate_key": ("a: 1\na: 2\n", 2),
    "mapping_in_list": ("a:\n  - b: 1\n", 2),
    "nested_list": ("a:\n  - - 1\n", 2),
    "octal": ("a: 010\n", 1),
    "underscored": ("a: 1_000\n", 1),
    "sexagesimal": ("a: 1:30\n", 1),
    "date": ("a: 2024-01-31\n", 1),
    "complex_key": ("? a\n: 1\n", 1),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "bad_indent": ("a: 1\n  b: 2\n", 2),
    "bare_scalar": ("just text\n", 1),
    "double_quoted_escape": ("a: 1\nb: \"\\u00e9t\\x41\"\n", 2),
    "double_quoted_backslash": ("a: \"C:\\\\data\"\n", 1),
    "single_quoted_key": ("'a': 1\n", 1),
    "double_quoted_key": ("a: 1\n\"b\": 2\n", 2),
}


def _write(tmp_path, text):
    path = tmp_path / "file.yaml"
    path.write_bytes(text.encode("utf-8"))
    return str(path)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", SUBJECT_FILES, ids=os.path.basename)
def test_subject_lists_read_as_yaml_reads_them(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = load_yaml(path)
    assert _same(got, want)
    assert len(got["subject"]) in (15, 80)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_subset_reads_as_yaml_reads_it(tmp_path, name):
    text = VARIANTS[name]
    assert _same(load_yaml(_write(tmp_path, text)), yaml.safe_load(text)), name


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_syntax_outside_the_subset_raises_with_its_line(tmp_path, name):
    text, line = REFUSED[name]
    with pytest.raises(ValueError, match=rf"^line {line}: "):
        load_yaml(_write(tmp_path, text))


def test_empty_file_is_none(tmp_path):
    assert load_yaml(_write(tmp_path, "# only a comment\n\n")) is None
    assert yaml.safe_load("# only a comment\n\n") is None


def test_model_config_reads_jax_type_names_as_the_port(tmp_path):
    """A config naming the JAX package's class builds the port's model with
    the same parameters, as the JAX package's build_model_from_cfg builds
    its own."""
    path = _write(tmp_path, VARIANTS["model_config"])
    model = build_model_from_cfg(path)
    assert isinstance(model, FeatRotationSymm)
    assert (model.backbone_depth, model.num_iter) == (18, 2)
    jax_model = jax_build_model_from_cfg(path)
    assert isinstance(jax_model, JaxFeatRotationSymm)
    assert (jax_model.backbone_depth, jax_model.num_iter) == (18, 2)
    port_path = _write(tmp_path, "type: rot_mvgaze_tpu_torch.models.FeatRotationSymm\nparams:\n"
                                 "  backbone_depth: 18\n  num_iter: 1\n  share_weights: true\n")
    model = build_model_from_cfg(port_path)
    assert (model.num_iter, model.share_weights) == (1, True)
