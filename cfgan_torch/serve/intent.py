"""Natural-language intent parsing for the promptable front ends (mirrors
`cfgan/serve/intent.py`).

Two intent families:
* image chat actions: the assistant (an LLM, or the regex fallback of
  `MnistChatBackend`) embeds a hidden JSON action in an HTML comment,
  `show_digit {value}` or `transform_digit {target, patches}`, which
  `extract_action` finds and validates;
* tabular feature instructions: free text -> the list of features the
  user allows to change, through an LLM where a provider is configured,
  else a regex and synonym matcher.

LLM providers are keyed from the environment only (GEMINI_API_KEY or
GOOGLE_API_KEY, then OPENAI_API_KEY), and their packages are imported
only inside `llm_client`: with no key, or with the provider's package
missing, it returns None and the regex path serves.  No key is carried
in the code.
"""
from __future__ import annotations

import json
import os
import re
from typing import Sequence

from cfgan_torch.core.config import TabularSchema

ACTION_RE = re.compile(r"<!--\s*(\{.*?\})\s*-->", re.DOTALL)


def extract_action(text: str, num_classes: int = 10,
                   num_patches: int = 16) -> dict | None:
    """The hidden JSON action of an LLM reply, validated: None where it is
    absent, not JSON, an unknown action, or a target or patch that is not
    an int in range (JSON booleans are rejected)."""
    m = ACTION_RE.search(text or "")
    if not m:
        return None
    try:
        action = json.loads(m.group(1))
    except json.JSONDecodeError:
        return None

    def _is_int(v):  # JSON booleans are ints in Python; reject them
        return isinstance(v, int) and not isinstance(v, bool)

    name = action.get("action")
    if name == "show_digit":
        v = action.get("value")
        if _is_int(v) and 0 <= v < num_classes:
            return {"action": "show_digit", "value": v}
        return None
    if name == "transform_digit":
        t = action.get("target")
        patches = action.get("patches")
        if not (_is_int(t) and 0 <= t < num_classes):
            return None
        if not isinstance(patches, list) or not patches:
            return None
        clean = [p for p in patches
                 if _is_int(p) and 0 <= p < num_patches]
        if len(clean) != len(patches):
            return None
        return {"action": "transform_digit", "target": t, "patches": clean}
    return None


def strip_action(text: str) -> str:
    """The user-visible reply, with the hidden action comment removed."""
    return ACTION_RE.sub("", text or "").strip()


# ------------------------------------------------------------ tabular masks
_SYNONYMS = {
    "bedrooms": ("bedroom", "beds", "bed "),
    "bathrooms": ("bathroom", "baths", "bath "),
    "sqft_living": ("living", "interior", "size", "area", "square footage",
                    "sqft"),
    "sqft_lot": ("lot", "land", "yard"),
    "floors": ("floor", "storey", "stories", "levels"),
    "waterfront": ("waterfront", "water front", "lake", "shore"),
    "view": ("view",),
    "condition": ("condition", "state of repair"),
    "grade": ("grade", "quality", "construction"),
    "sqft_above": ("above ground", "above-ground", "upstairs"),
    "sqft_basement": ("basement",),
    "sqft_living15": ("neighbors living", "nearby living"),
    "sqft_lot15": ("neighbors lot", "nearby lot"),
}


def parse_feature_instruction(
    text: str,
    schema: TabularSchema,
    synonyms: dict[str, Sequence[str]] | None = None,
) -> list[str]:
    """Free text -> the allowed (mutable) feature names, in schema order.

    'everything' / 'any' allows every mutable feature; otherwise each
    mutable feature the text mentions (its name, the name with spaces, or
    a synonym) is allowed.  Immutable features are never returned."""
    text_l = (text or "").lower()
    mutable = [f for f in schema.feature_names
               if f not in schema.immutable_features]
    if re.search(r"\b(everything|anything|any feature|all features|all)\b",
                 text_l):
        return mutable
    syn = {**_SYNONYMS, **(synonyms or {})}
    allowed = []
    for f in mutable:
        terms = (f, f.replace("_", " "), *(syn.get(f, ())))
        if any(t.strip() and t.strip() in text_l for t in terms):
            allowed.append(f)
    return allowed


def parse_feature_instruction_llm(text: str,
                                  schema: TabularSchema) -> list[str]:
    """The LLM variant: asks the configured provider for a JSON list of
    allowed features, keeps the mutable ones it names, and falls back to
    `parse_feature_instruction` where no provider is configured, the call
    fails, or no mutable feature is left."""
    client = llm_client()
    if client is None:
        return parse_feature_instruction(text, schema)
    prompt = (
        "A user describes which house features they are willing to change.\n"
        f"Feature names: {list(schema.feature_names)}\n"
        f"Immutable (never include): {list(schema.immutable_features)}\n"
        f"User instruction: {text!r}\n"
        'Reply with ONLY a JSON list of allowed feature names, e.g. '
        '["bedrooms", "grade"].'
    )
    try:
        reply = client(prompt)
        m = re.search(r"\[.*\]", reply, re.DOTALL)
        allowed = json.loads(m.group(0)) if m else []
        mutable = set(schema.feature_names) - set(schema.immutable_features)
        out = [f for f in allowed if f in mutable]
        return out or parse_feature_instruction(text, schema)
    except Exception:
        return parse_feature_instruction(text, schema)


# --------------------------------------------------------------- providers
def llm_client():
    """`chat(prompt) -> str` of the first configured provider, else None:
    Gemini where GEMINI_API_KEY or GOOGLE_API_KEY is set and
    `google.generativeai` imports, then OpenAI where OPENAI_API_KEY is set
    and `openai` imports.  The model names come from CFGAN_GEMINI_MODEL /
    CFGAN_OPENAI_MODEL."""
    gem_key = os.environ.get("GEMINI_API_KEY") or os.environ.get(
        "GOOGLE_API_KEY"
    )
    if gem_key:
        try:
            import google.generativeai as genai

            genai.configure(api_key=gem_key)
            model = genai.GenerativeModel(
                os.environ.get("CFGAN_GEMINI_MODEL", "gemini-2.5-flash")
            )
            return lambda prompt: model.generate_content(prompt).text
        except ImportError:
            pass
    oai_key = os.environ.get("OPENAI_API_KEY")
    if oai_key:
        try:
            from openai import OpenAI

            client = OpenAI(api_key=oai_key)

            def chat(prompt: str) -> str:
                r = client.chat.completions.create(
                    model=os.environ.get("CFGAN_OPENAI_MODEL", "gpt-4o-mini"),
                    messages=[{"role": "user", "content": prompt}],
                )
                return r.choices[0].message.content

            return chat
        except ImportError:
            pass
    return None
