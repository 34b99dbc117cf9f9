"""`cfgan_torch.serve.intent` against `cfgan.serve.intent` on the same
inputs: the hidden chat actions (`extract_action`, `strip_action`), the
feature instructions (`parse_feature_instruction` on each package's own
King County schema, and the LLM variant's fallbacks with scripted
clients) and `llm_client()` with no provider.  Every test clears the
providers' keys, and no test reaches a network: the clients are
scripted, and a provider's package is made unimportable where a key is
set."""
import sys

import pytest

from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.serve import intent as jintent
from cfgan_torch.core.config import TabularSchema
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.serve import intent

KEYS = ("GEMINI_API_KEY", "GOOGLE_API_KEY", "OPENAI_API_KEY")


@pytest.fixture(autouse=True)
def no_keys(monkeypatch):
    for k in KEYS:
        monkeypatch.delenv(k, raising=False)


def _c(body: str) -> str:
    return f"Sure. <!-- {body} --> done"


REPLIES = {
    "show": _c('{"action": "show_digit", "value": 3}'),
    "show_zero": _c('{"action": "show_digit", "value": 0}'),
    "show_bool": _c('{"action": "show_digit", "value": true}'),
    "show_float": _c('{"action": "show_digit", "value": 3.0}'),
    "show_string": _c('{"action": "show_digit", "value": "3"}'),
    "show_out_of_range": _c('{"action": "show_digit", "value": 10}'),
    "show_negative": _c('{"action": "show_digit", "value": -1}'),
    "transform": _c('{"action": "transform_digit", "target": 8, '
                    '"patches": [5, 6, 9, 10]}'),
    "transform_edges": _c('{"action": "transform_digit", "target": 9, '
                          '"patches": [0, 15]}'),
    "transform_bool_target": _c('{"action": "transform_digit", '
                                '"target": true, "patches": [1]}'),
    "transform_bool_patch": _c('{"action": "transform_digit", '
                               '"target": 1, "patches": [true]}'),
    "transform_target_out": _c('{"action": "transform_digit", '
                               '"target": 10, "patches": [1]}'),
    "transform_patch_out": _c('{"action": "transform_digit", '
                              '"target": 1, "patches": [1, 16]}'),
    "transform_no_patches": _c('{"action": "transform_digit", '
                               '"target": 1, "patches": []}'),
    "transform_patches_not_list": _c('{"action": "transform_digit", '
                                     '"target": 1, "patches": 5}'),
    "transform_missing_target": _c('{"action": "transform_digit", '
                                   '"patches": [1]}'),
    "unknown_action": _c('{"action": "erase", "value": 1}'),
    "broken_json": _c('{"action": show_digit, "value": 3}'),
    "multiline": 'a\n<!--\n{"action": "show_digit",\n "value": 7}\n-->\nb',
    "two_comments": (_c('{"action": "show_digit", "value": 1}')
                     + _c('{"action": "show_digit", "value": 2}')),
    "no_comment": "Just text, no action.",
    "empty": "",
}


@pytest.mark.parametrize("name", REPLIES)
@pytest.mark.parametrize("num_classes,num_patches", [(10, 16), (4, 9)])
def test_extract_action_matches_jax(name, num_classes, num_patches):
    text = REPLIES[name]
    got = intent.extract_action(text, num_classes, num_patches)
    assert got == jintent.extract_action(text, num_classes, num_patches)


def test_extract_action_table_is_not_vacuous():
    valid = {n for n in REPLIES if intent.extract_action(REPLIES[n])}
    assert valid == {"show", "show_zero", "transform", "transform_edges",
                     "multiline", "two_comments"}
    assert intent.extract_action(None) is None
    assert intent.extract_action(REPLIES["two_comments"]) == {
        "action": "show_digit", "value": 1}


@pytest.mark.parametrize("name", REPLIES)
def test_strip_action_matches_jax(name):
    got = intent.strip_action(REPLIES[name])
    assert got == jintent.strip_action(REPLIES[name])
    assert "<!--" not in got or name == "broken_json"


INSTRUCTIONS = [
    "only bedrooms, bathrooms and grade",
    "change everything",
    "anything goes",
    "you may alter all features",
    "the lot and the view",
    "the bed and the bath ",
    "more square footage, a better construction quality",
    "sqft_living15 and sqft_lot15",
    "the neighbors lot, the basement, and upstairs space",
    "waterfront by the lake",
    "move it to another zipcode and latitude",
    "only the yr_built",
    "make it cheaper",
    "",
    "BEDROOMS and Floors",
    "condition and state of repair",
    "tall",
]


@pytest.mark.parametrize("text", INSTRUCTIONS)
def test_parse_feature_instruction_matches_jax(text):
    got = intent.parse_feature_instruction(text, KC_SCHEMA)
    assert got == jintent.parse_feature_instruction(text, JAX_SCHEMA)
    assert not set(got) & set(KC_SCHEMA.immutable_features)


def test_parse_feature_instruction_examples():
    assert intent.parse_feature_instruction(
        "only bedrooms, bathrooms and grade", KC_SCHEMA) == [
        "bedrooms", "bathrooms", "grade"]
    assert intent.parse_feature_instruction("change everything",
                                            KC_SCHEMA) == [
        f for f in KC_SCHEMA.feature_names
        if f not in KC_SCHEMA.immutable_features]
    assert intent.parse_feature_instruction("make it cheaper",
                                            KC_SCHEMA) == []


def test_parse_feature_instruction_custom_synonyms_and_schema():
    from cfgan.core.config import TabularSchema as JaxSchema

    kw = dict(feature_names=("age", "income", "debt_ratio"),
              immutable_features=("age",))
    syn = {"income": ("salary", "pay"), "age": ("years",)}
    for text in ("raise the salary", "lower the debt ratio and pay",
                 "years", "all"):
        got = intent.parse_feature_instruction(text, TabularSchema(**kw),
                                               syn)
        assert got == jintent.parse_feature_instruction(
            text, JaxSchema(**kw), syn)
    assert intent.parse_feature_instruction(
        "raise the salary", TabularSchema(**kw), syn) == ["income"]


def _scripted(reply):
    def client(prompt):
        if isinstance(reply, Exception):
            raise reply
        return reply
    return client


LLM_CASES = {
    "fails": RuntimeError("provider down"),
    "immutable_only": '["lat", "zipcode"]',
    "mixed": 'Sure: ["grade", "lat", "view"] as asked',
    "not_json": "[grade, view]",
    "no_list": "I cannot help with that.",
    "unknown_names": '["garage", "pool"]',
}


@pytest.mark.parametrize("case", LLM_CASES)
def test_parse_feature_instruction_llm_matches_jax(monkeypatch, case):
    """The provider's reply is kept to its mutable features, and any
    failure or empty result falls back to the regex parser, in both
    packages; both send the same prompt."""
    prompts = {}

    def client_for(pkg):
        def client(prompt):
            prompts[pkg] = prompt
            return _scripted(LLM_CASES[case])(prompt)
        return lambda: client

    monkeypatch.setattr(intent, "llm_client", client_for("port"))
    monkeypatch.setattr(jintent, "llm_client", client_for("jax"))
    text = "only the bedrooms and the grade"
    got = intent.parse_feature_instruction_llm(text, KC_SCHEMA)
    assert got == jintent.parse_feature_instruction_llm(text, JAX_SCHEMA)
    assert prompts["port"] == prompts["jax"]
    want = {"mixed": ["grade", "view"]}.get(
        case, intent.parse_feature_instruction(text, KC_SCHEMA))
    assert got == want


def test_parse_feature_instruction_llm_without_a_provider():
    assert intent.llm_client() is None
    text = "the lot and the view"
    assert intent.parse_feature_instruction_llm(text, KC_SCHEMA) == \
        intent.parse_feature_instruction(text, KC_SCHEMA) == [
            "sqft_lot", "view"]


def test_llm_client_is_none_without_keys():
    assert intent.llm_client() is None
    assert jintent.llm_client() is None


@pytest.mark.parametrize("key", KEYS)
def test_llm_client_is_none_where_the_provider_package_is_missing(
        monkeypatch, key):
    """A key with no provider package to use it: None, as in JAX."""
    for mod in ("google.generativeai", "openai"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setenv(key, "not-a-real-key")
    assert intent.llm_client() is None
    assert jintent.llm_client() is None
