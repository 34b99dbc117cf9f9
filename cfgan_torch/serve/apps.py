"""The promptable front ends of the three CounteRGAN families (mirrors
`cfgan/serve/apps.py`):

* the MNIST chat app: a chat that shows digits under their numbered patch
  grid and turns the shown digit into another class by changing only the
  patches the user names;
* the house app: a sample browser, a natural-language instruction parsed
  into a feature mask, and the counterfactual's table of changes;
* the moons app: a mask policy to pick, the decision boundaries and the
  counterfactual's arrow.

Every decision lives in the backends (`MnistChatBackend`, `HouseBackend`,
`MoonsBackend`), which need no UI and run on the engine's device (the
CUDA card unless the engine was built elsewhere); the figures are drawn
by the port's raster (`cfgan_torch.eval.figure`), and the tables are
`Table`s, not pandas frames.  gradio is optional and imported only inside
`build_*_app`, which raise a clear `ImportError` without it; the builders
are thin bindings of gradio components to the backends' methods.  Chat
replies come from `intent.llm_client()` where a provider is configured,
else from the regex fallback.

A backend holds one session's state (the sample shown, and a
`np.random.RandomState`): make one per user session; only the engine
underneath may be shared between threads.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Mapping, Sequence

import numpy as np

from cfgan_torch.eval.figure import Figure
from cfgan_torch.eval.tabular import descending_order
from cfgan_torch.serve import intent

DPI = 120

MNIST_SYSTEM_PROMPT = """You are an assistant for a counterfactual-digit \
demo. The user can ask to see a digit or transform a displayed digit into \
another class by modifying only certain patches (numbered 0-15, row-major \
over a 4x4 grid of 7x7 patches). When the user asks to see a digit, append \
a hidden action comment: <!-- {"action": "show_digit", "value": D} -->. \
When the user asks for a transformation, append: \
<!-- {"action": "transform_digit", "target": T, "patches": [..]} -->. \
Reply conversationally; the comment must be valid JSON."""


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; the cfgan_torch serve apps need it. "
            "The serving engine (cfgan_torch.serve.engine) and the HTTP API "
            "(python -m cfgan_torch.serve.launch --api) work without it."
        ) from e


def _tmp_png() -> str:
    fd, path = tempfile.mkstemp(suffix=".png", prefix="cfgan_")
    os.close(fd)
    return path


class Table(dict):
    """A table without pandas, in the form `gr.Dataframe` takes as its
    value: the dict `{"headers": [column names], "data": [[one row's
    values], ...]}`, rows in order, numbers as Python floats.
    `columns` is the headers; `column(name)` one column as a numpy
    array."""

    def __init__(self, columns: Mapping[str, Sequence],
                 order: Sequence[int] | None = None):
        cols = [np.asarray(v).tolist() for v in columns.values()]
        rows = range(len(cols[0])) if order is None else order
        super().__init__(headers=list(columns),
                         data=[[c[i] for c in cols] for i in rows])

    @property
    def columns(self) -> list[str]:
        return self["headers"]

    def column(self, name: str) -> np.ndarray:
        j = self["headers"].index(name)
        return np.asarray([row[j] for row in self["data"]])


# ------------------------------------------------------------------- MNIST
class MnistChatBackend:
    """The state machine behind the MNIST chat app, with no UI.

    `engine` is an image `CounterfactualEngine`; `x_test` (N, H, W, 1) in
    [-1, 1] and `y_test` its labels.  `llm=None` takes the provider of
    `intent.llm_client()` (None where none is configured), `llm=False`
    the regex fallback, and a callable `llm(prompt) -> str` is used as
    it is."""

    def __init__(self, engine, x_test, y_test, patch_size: int = 7,
                 llm=None, seed: int = 0):
        self.engine = engine
        self.x = np.asarray(x_test)
        self.y = np.asarray(y_test)
        self.patch_size = patch_size
        self.rng = np.random.RandomState(seed)
        self.llm = intent.llm_client() if llm is None else (llm or None)
        self.current_idx: int | None = None
        self.by_digit = {d: np.nonzero(self.y == d)[0]
                         for d in range(engine.num_classes)}
        h = self.x.shape[1]
        self.n_patches = (h // patch_size) ** 2

    def reply(self, message: str, history: list[tuple[str, str]]):
        """(assistant text, image path or None)."""
        if self.llm:
            transcript = "".join(
                f"\nUser: {u}\nAssistant: {a}" for u, a in history
            )
            raw = self.llm(
                f"{MNIST_SYSTEM_PROMPT}{transcript}\nUser: {message}\n"
                "Assistant:"
            )
        else:
            raw = self._deterministic_reply(message)
        action = intent.extract_action(raw, self.engine.num_classes,
                                       self.n_patches)
        text = intent.strip_action(raw)
        img = None
        if action and action["action"] == "show_digit":
            img = self.show_digit(action["value"])
        elif action and action["action"] == "transform_digit":
            img, ok, pred, conf = self.transform(action["target"],
                                                 action["patches"])
            text += (f"\n\nResult: classifier says {pred} "
                     f"({conf:.2f} confidence) — "
                     + ("flip succeeded." if ok else "no flip."))
        return text, img

    def _deterministic_reply(self, message: str) -> str:
        """The regex fallback where no LLM provider is configured."""
        m = re.search(r"show\D*(\d)", message.lower())
        if m:
            return (f"Here is a {m.group(1)}. "
                    '<!-- {"action": "show_digit", "value": '
                    f'{m.group(1)}}} -->')
        m = re.search(
            r"(?:transform|turn|make|change).*?(?:into|to)\D*(\d).*?"
            r"patch(?:es)?\s*([\d,\s]+)", message.lower(), re.DOTALL,
        )
        if m:
            patches = [int(p) for p in m.group(2).replace(",", " ").split()]
            return ('Transforming. <!-- {"action": "transform_digit", '
                    f'"target": {m.group(1)}, "patches": {patches}}} -->')
        return ("I can 'show digit D' or 'transform it into T using "
                "patches i, j, ...'.")

    def show_digit(self, digit: int) -> str:
        """A random test image of `digit` under its numbered patch grid;
        the PNG's path."""
        from cfgan_torch.eval.images import patch_grid_overlay

        pool = self.by_digit.get(digit)
        if pool is None or len(pool) == 0:
            raise ValueError(f"no test samples of digit {digit}")
        self.current_idx = int(self.rng.choice(pool))
        path = _tmp_png()
        patch_grid_overlay(self.x[self.current_idx], self.patch_size, path)
        return path

    def transform(self, target: int, patches: list[int]):
        """The shown image (a random one if none is shown) towards
        `target`, changed only inside `patches`, on the engine's device:
        (4-panel PNG path, flipped, pred, confidence)."""
        from cfgan_torch.eval.images import user_modification_example

        if self.current_idx is None:
            self.current_idx = int(self.rng.randint(len(self.y)))
        path = _tmp_png()
        engine = self.engine
        res = user_modification_example(
            # the figure's cf_fn(g_vars, x, t, mask, key) over the
            # engine's cf_fn(x, t, mask, key), which holds its weights
            lambda _, x, t, mask, key=None: engine.cf_fn(x, t, mask, key),
            engine.clf_fn, None, self.x[self.current_idx], target, patches,
            self.patch_size, path=path, device=engine.device,
        )
        return (path, bool(res["pred"] == target), res["pred"],
                res["confidence"])


def build_mnist_app(engine, x_test, y_test, patch_size: int = 7):
    gr = _require_gradio()
    backend = MnistChatBackend(engine, x_test, y_test, patch_size)

    with gr.Blocks(title="Promptable MNIST counterfactuals") as demo:
        gr.Markdown("# Promptable MNIST counterfactuals\n"
                    "Ask to *show* a digit, then *transform* it using "
                    "specific patches.")
        chat = gr.Chatbot(height=380)
        img = gr.Image(label="Current digit / result", type="filepath")
        box = gr.Textbox(label="Message")

        def respond(message, history):
            history = history or []
            text, image = backend.reply(message, history)
            history = history + [(message, text)]
            return history, image, ""

        box.submit(respond, [box, chat], [chat, img, box])
    return demo


# ------------------------------------------------------------------- house
class HouseBackend:
    """The logic behind the house app, with no UI.  `engine` is a tabular
    `CounterfactualEngine`, `x_test` in its [0, 1] data space, `stats`
    the `NormStats` back to the features' units, `bins` the price-class
    edges."""

    def __init__(self, engine, x_test, y_test, schema, stats, bins=None,
                 seed: int = 0):
        self.engine = engine
        self.x = np.asarray(x_test)
        self.y = np.asarray(y_test)
        self.schema = schema
        self.stats = stats
        self.bins = bins
        self.rng = np.random.RandomState(seed)
        self.current_idx = 0

    def class_overview(self) -> str:
        """The price range of each class."""
        if self.bins is None:
            return "4 price quartile classes (Q0 cheapest .. Q3 priciest)."
        lines = [f"- class {i}: ${lo:,.0f} – ${hi:,.0f}"
                 for i, (lo, hi) in enumerate(zip(self.bins[:-1],
                                                  self.bins[1:]))]
        return "Price classes:\n" + "\n".join(lines)

    def show_sample(self, source_class: int):
        """A random test row of `source_class`: (`Table` of columns
        `feature, value` in the features' units, the classifier's
        probabilities as text)."""
        pool = np.nonzero(self.y == int(source_class))[0]
        if len(pool) == 0:
            raise ValueError(f"no test samples of class {source_class}")
        self.current_idx = int(self.rng.choice(pool))
        x = self.x[self.current_idx]
        raw = np.asarray(self.stats.inverse_transform(x))
        probs = self.engine.classify(x)[0]
        table = Table({"feature": self.schema.feature_names, "value": raw})
        prob_txt = " | ".join(f"Q{i}: {p:.2f}" for i, p in enumerate(probs))
        return table, f"Classifier: {prob_txt}"

    def generate(self, target_class: int, instruction: str):
        """The instruction's allowed features as the mask (every mutable
        feature where it names none), then the counterfactual of the
        current row: (`Table` of columns `feature, original,
        counterfactual, change, abs_delta`, rows by `abs_delta` descending
        in pandas' `sort_values(ascending=False)` order, ties included;
        the verdict)."""
        allowed = intent.parse_feature_instruction_llm(instruction or "",
                                                       self.schema)
        if not allowed:
            allowed = [f for f in self.schema.feature_names
                       if f not in self.schema.immutable_features]
        x = self.x[self.current_idx][None]
        mask = self.engine.mask_from_feature_names(allowed, 1)
        res = self.engine.generate(x, int(target_class), mask)
        orig_raw = np.asarray(self.stats.inverse_transform(x[0]))
        cf_raw = np.asarray(self.stats.inverse_transform(res.x_cf[0]))
        abs_delta = np.abs(res.x_cf[0] - x[0])
        table = Table({"feature": self.schema.feature_names,
                       "original": orig_raw, "counterfactual": cf_raw,
                       "change": cf_raw - orig_raw, "abs_delta": abs_delta},
                      order=descending_order(abs_delta))
        verdict = (f"prediction {res.pred[0]} at {res.confidence[0]:.2f}; "
                   f"allowed features: {', '.join(allowed)}")
        return table, verdict


def build_house_app(engine, x_test, y_test, schema, stats, bins=None):
    gr = _require_gradio()
    backend = HouseBackend(engine, x_test, y_test, schema, stats, bins)

    with gr.Blocks(title="House price counterfactuals") as demo:
        gr.Markdown("# Promptable housing counterfactuals\n"
                    + backend.class_overview())
        src = gr.Dropdown([0, 1, 2, 3], value=0, label="Source class")
        show = gr.Button("Show random sample")
        table = gr.Dataframe(label="Sample")
        probs = gr.Markdown()
        instr = gr.Textbox(label="What may change? (natural language)")
        tgt = gr.Dropdown([0, 1, 2, 3], value=3, label="Target class")
        go = gr.Button("Generate counterfactual")
        diff = gr.Dataframe(label="Counterfactual diff")
        verdict = gr.Markdown()
        show.click(backend.show_sample, [src], [table, probs])
        go.click(backend.generate, [tgt, instr], [diff, verdict])
    return demo


# ------------------------------------------------------------------- moons
class MoonsBackend:
    """The logic behind the moons app, with no UI.  `clf_fn` gives the
    classifier's logits on the engine's device."""

    MASK_ROWS = {"both": (1.0, 1.0), "x_only": (1.0, 0.0),
                 "y_only": (0.0, 1.0), "none": (0.0, 0.0)}

    def __init__(self, engine, clf_fn, x_test, y_test, seed: int = 0):
        self.engine = engine
        self.clf_fn = clf_fn
        self.x = np.asarray(x_test)
        self.y = np.asarray(y_test)
        self.rng = np.random.RandomState(seed)
        self.current_idx = 0

    def show_sample(self, source_class: int) -> str:
        """A random test point of `source_class`, starred on the decision
        boundaries; the PNG's path."""
        from cfgan_torch.eval.boundaries import plot_decision_boundaries_only

        pool = np.nonzero(self.y == int(source_class))[0]
        if len(pool) == 0:
            raise ValueError(f"no test samples of class {source_class}")
        self.current_idx = int(self.rng.choice(pool))
        path = _tmp_png()
        plot_decision_boundaries_only(
            self.clf_fn, self.x, self.y, path,
            num_classes=self.engine.num_classes,
            highlight=self.x[self.current_idx], device=self.engine.device,
        )
        return path

    def generate(self, target_class: int, mask_choice: str):
        """The current point's counterfactual under the mask policy
        `mask_choice`: (arrow plot's PNG path, `CFResult`, verdict)."""
        x = self.x[self.current_idx][None]
        mask = np.asarray([self.MASK_ROWS[mask_choice]], np.float32)
        res = self.engine.generate(x, int(target_class), mask)
        path = _tmp_png()
        fig = Figure(figsize=(5, 4), dpi=DPI)
        ax = fig.subplots()[0, 0]
        ax.scatter(self.x[:, 0], self.x[:, 1], c=self.y, s=6, alpha=0.3)
        ax.arrow(x[0], res.x_cf[0], color="red", linewidth=2)
        ax.set_title(f"pred {res.pred[0]} ({res.confidence[0]:.2f})")
        fig.save(path)
        return path, res, ("flip succeeded" if res.flipped[0] else "no flip")


def build_moons_app(engine, clf_fn, x_test, y_test):
    gr = _require_gradio()
    backend = MoonsBackend(engine, clf_fn, x_test, y_test)

    def generate_ui(target_class, mask_choice):
        path, _, verdict = backend.generate(target_class, mask_choice)
        return path, verdict

    with gr.Blocks(title="Moons counterfactuals") as demo:
        gr.Markdown("# Moons counterfactuals")
        src = gr.Dropdown([0, 1, 2], value=0, label="Source class")
        show = gr.Button("Show random sample")
        img = gr.Image(type="filepath")
        mask = gr.Radio(list(MoonsBackend.MASK_ROWS), value="both",
                        label="Modifiable dims")
        tgt = gr.Dropdown([0, 1, 2], value=1, label="Target class")
        go = gr.Button("Generate")
        out = gr.Image(type="filepath")
        msg = gr.Markdown()
        show.click(backend.show_sample, [src], [img])
        go.click(generate_ui, [tgt, mask], [out, msg])
    return demo
