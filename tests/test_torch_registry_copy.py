"""The port's copies of the JAX package's task registry and tokenizer hold to
the originals, and its entry points run on the card unless asked otherwise.

The port imports nothing of the JAX package (``tests/test_torch_no_jax.py``),
so it carries ``registry/`` and ``utils/tokenization.py`` of its own; these
tests compare them with the originals: every dataset config field by field
(enum members by value, the two packages' enums being separate classes), the
catalog's helpers, and the in-repo tokenizer on a set of strings.
"""

import ast
import dataclasses
import enum
import inspect

import pytest

from icl_speech_text_llm_tpu import config as jconfig
from icl_speech_text_llm_tpu import registry as jregistry
from icl_speech_text_llm_tpu.config import static_configs as jstatic
from icl_speech_text_llm_tpu.utils import logging_utils as jlogging
from icl_speech_text_llm_tpu.utils import tokenization as jtok
from icl_speech_text_llm_tpu_torch import bridge
from icl_speech_text_llm_tpu_torch import config as tconfig
from icl_speech_text_llm_tpu_torch import registry as tregistry
from icl_speech_text_llm_tpu_torch import symbol_adapter
from icl_speech_text_llm_tpu_torch.cli import interactive, symbol_inference
from icl_speech_text_llm_tpu_torch.config import static_configs as tstatic
from icl_speech_text_llm_tpu_torch.data import fewshot_retrieval
from icl_speech_text_llm_tpu_torch.inference.engine import SalmonnEngine
from icl_speech_text_llm_tpu_torch.inference.serving import ContinuousBatchingEngine
from icl_speech_text_llm_tpu_torch.models import factory
from icl_speech_text_llm_tpu_torch.models.llama import init_kv_cache
from icl_speech_text_llm_tpu_torch.parallel import mesh, multihost
from icl_speech_text_llm_tpu_torch.utils import logging_utils as tlogging
from icl_speech_text_llm_tpu_torch.utils import memory
from icl_speech_text_llm_tpu_torch.utils import tokenization as ttok


def _plain(x):
    """A config value with every enum replaced by its value."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def test_enums_have_the_same_members():
    for name in ("DatasetType", "DatasetSplit"):
        j, t = getattr(jregistry, name), getattr(tregistry, name)
        assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]
        assert j is not t


def test_every_dataset_config_equals_the_original_field_by_field():
    assert [k.value for k in jregistry.DATASET_CONFIGS] == \
        [k.value for k in tregistry.DATASET_CONFIGS]
    for jtype in jregistry.DatasetType:
        ttype = tregistry.DatasetType(jtype.value)
        jcfg, tcfg = jregistry.get_dataset_config(jtype), tregistry.get_dataset_config(ttype)
        assert (jcfg is None) == (tcfg is None), jtype
        if jcfg is None:
            continue
        assert [f.name for f in dataclasses.fields(jcfg)] == \
            [f.name for f in dataclasses.fields(tcfg)]
        for f in dataclasses.fields(jcfg):
            assert _plain(getattr(jcfg, f.name)) == _plain(getattr(tcfg, f.name)), \
                (jtype, f.name)


def test_catalog_helpers_match():
    for spec in ("voxceleb-hvb", "voxceleb,meld_emotion", "sqa"):
        assert [t.value for t in jregistry.parse_dataset_types(spec)] == \
            [t.value for t in tregistry.parse_dataset_types(spec)]
    assert {k.value for k in jregistry.SWAP_TYPES} == {k.value for k in tregistry.SWAP_TYPES}
    for jtype in sorted(jregistry.SWAP_TYPES, key=lambda t: t.value):
        ttype = tregistry.DatasetType(jtype.value)
        assert _plain(dataclasses.asdict(jregistry.get_swap_config(jtype))) == \
            _plain(dataclasses.asdict(tregistry.get_swap_config(ttype)))
    examples = [{"label": "positive"}, {"label": "negative"}, {"label": "x"}]
    mapping = {"positive": "negative", "negative": "positive"}
    assert jregistry.apply_label_mapping(examples, mapping) == \
        tregistry.apply_label_mapping(examples, mapping)


STRINGS = [
    "", "a", "hello world", "The quick brown fox jumps over the lazy dog.",
    "positive", " negative neutral", "ÜBER naïve café — 東京 🎉", "tab\tnew\nline",
    "xyzzy qwerty asdf", "12345 !@#$%^&*()", "  leading and trailing  ",
]


def test_tiny_tokenizer_encodes_and_decodes_as_the_original():
    j, t = jtok.get_tokenizer(), ttok.get_tokenizer()
    assert (j.vocab_size, j.pad_token_id, j.bos_token_id, j.eos_token_id) == \
        (t.vocab_size, t.pad_token_id, t.bos_token_id, t.eos_token_id)
    for s in STRINGS:
        for special in (False, True):
            ids = j.encode(s, add_special_tokens=special)
            assert t.encode(s, add_special_tokens=special) == ids, s
            for skip in (False, True):
                assert t.decode(ids, skip_special_tokens=skip) == \
                    j.decode(ids, skip_special_tokens=skip)
    ids = [0, 1, 2, 3, 40, 300, 36763, 40000]
    assert t.batch_decode([ids, ids[:3]]) == j.batch_decode([ids, ids[:3]])


@pytest.mark.parametrize("fn,arg", [
    (factory.create_model, "device"), (factory.SalmonnModel.__init__, "device"),
    (SalmonnEngine.__init__, "device"), (bridge.params_from_numpy, "device"),
    (init_kv_cache, "device"), (ContinuousBatchingEngine.__init__, "device"),
    (factory.QwenAudioModel.__init__, "device"),
    (symbol_adapter.build_training_world, "device"),
    (symbol_adapter.InferenceOrchestrator.__init__, "device"),
    (symbol_adapter.init_mlp_adapter, "device"),
    (fewshot_retrieval.topk_similar, "device"),
    (fewshot_retrieval.build_fewshot_dataset, "device"),
    (memory.BatchSizeOptimizer.__init__, "device"), (memory.peak_bytes, "device"),
    (memory.get_device_memory_stats, "device"),
    (multihost.initialize_distributed, "device"), (mesh.make_mesh, "device")])
def test_entry_points_default_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


@pytest.mark.parametrize("parse", [
    lambda: symbol_adapter.parse_training_args([]),
    lambda: symbol_inference.build_parser().parse_args(["--checkpoint", "c"]),
    lambda: interactive.build_parser().parse_args([])],
    ids=["symbol_train", "symbol_inference", "interactive"])
def test_cli_entry_points_default_to_the_card(parse):
    assert parse().device == "cuda"


def _code_lines(module):
    """The module's source below its docstring."""
    src = inspect.getsource(module)
    doc = ast.parse(src).body[0]
    return src.splitlines()[doc.end_lineno:]


@pytest.mark.parametrize("jmod,tmod", [(jlogging, tlogging), (jstatic, tstatic),
                                       (jconfig, tconfig)],
                         ids=["logging_utils", "static_configs", "config"])
def test_framework_free_copies_hold_the_original_code(jmod, tmod):
    assert _code_lines(tmod) == _code_lines(jmod)


@pytest.mark.parametrize("model_type", ["salmonn", "salmonn-7b", "qwen2", "salmonn-tiny",
                                        "SALMONN-7B"])
@pytest.mark.parametrize("dataset_type", [None, "voxceleb", "hvb"])
def test_static_configs_equal_the_originals(model_type, dataset_type):
    assert tconfig.get_training_config(model_type, dataset_type) == \
        jconfig.get_training_config(model_type, dataset_type)
    assert tconfig.get_inference_config(model_type, dataset_type) == \
        jconfig.get_inference_config(model_type, dataset_type)


def test_static_configs_refuse_an_unknown_model_as_the_originals():
    for pkg in (jconfig, tconfig):
        with pytest.raises(ValueError, match="Unknown model type"):
            pkg.get_training_config("gpt-2")
