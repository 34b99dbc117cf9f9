"""HTTP API for counterfactual serving on the port (mirrors
`cfgan/serve/api.py`), standard library and numpy only.

Endpoints, status codes, JSON field names and error texts are the JAX
package's, so one client speaks to either server:

* ``GET  /health``  -> ``{"status": "ok", "num_classes": C, "kind": ...}``
  (kind: "image", "tabular" or "generic")
* ``GET  /stats``   -> per-endpoint request, error and sample counts and
  p50/p95/max latency over the last 1024 requests
* ``POST /classify``  body ``{"x": ...}`` -> ``{"probs", "pred"}``
* ``POST /counterfactual``  body ``{"x": ..., "target": int | [...]}``,
  at most one of ``"mask"`` (dense), ``"patches"`` (image engines) or
  ``"features"`` (tabular engines), and an optional int ``"seed"`` (the
  request's key, `jax_key(seed)`: the JAX server's `jax.random.key(seed)`)
  -> the `CFResult` fields
* ``POST /counterfactual_bulk``  the same and an optional ``"chunk"``
  (default 128) -> the same fields, through `generate_bulk`

Every POST also takes ``Content-Type: application/x-npz``, an
uncompressed npz of the same fields (0-d entries for the scalars; the
list-valued ``patches`` and ``features`` are JSON only).  The response
is npz for an npz request and JSON for a JSON one unless the ``Accept``
header prefers the other; errors are always JSON.  A single sample comes
back as a batch of one.

Four repairs of the JAX server (its behaviour is kept otherwise):

- an unknown POST path reads the request body before its 404, so a
  kept-alive connection stays in step (`api.py:356` leaves the body in
  the socket, where it is read as the next request line);
- a 0-d bool npz entry stays a bool and fails validation as a JSON bool
  does (`api.py:79` makes it an int, so a bool ``seed`` or ``target``
  passes);
- ``Accept`` is parsed as media ranges: the highest q above 0 wins, the
  earlier range on a tie, and q=0 refuses a type (`api.py:368` matches
  substrings, so ``application/x-npz;q=0`` still forces npz);
- the connections are TCP_NODELAY: the JAX server's kept-alive responses
  wait on Nagle's algorithm for the client's delayed ACK (40 ms at
  least on Linux).

`ThreadingHTTPServer` serves each connection in a thread of its own, all
on one engine (see `CounterfactualEngine`).  A failure other than a
client error is a 500 with the exception's text; nothing is retried.
"""
from __future__ import annotations

import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cfgan_torch.models.tabular import jax_key
from cfgan_torch.serve.engine import CounterfactualEngine

NPZ_CONTENT_TYPE = "application/x-npz"
JSON_CONTENT_TYPE = "application/json"
# npz archives are zip files: an octet-stream upload that starts with
# the zip magic goes to the npz decoder
_ZIP_MAGIC = b"PK\x03\x04"


class ApiError(ValueError):
    """Client error carried to a 400 response."""


def _decode_npz_body(raw: bytes) -> dict:
    """An npz request body as the dict the JSON path gives: arrays stay
    arrays; a 0-d integer entry becomes an int, a 0-d bool a bool and any
    other 0-d entry a float, so both wire formats meet one validation."""
    try:
        with np.load(io.BytesIO(raw), allow_pickle=False) as npz:
            body = {k: npz[k] for k in npz.files}
    except Exception as e:
        raise ApiError(f"invalid npz body: {e}") from e
    for k, v in body.items():
        if v.ndim == 0:
            body[k] = (int(v) if v.dtype.kind in "iu"
                       else bool(v) if v.dtype.kind == "b" else float(v))
    return body


def _encode_npz_payload(payload: dict) -> bytes:
    """A handler's result as an uncompressed npz."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
    return buf.getvalue()


def _jsonable(payload: dict) -> dict:
    """Arrays to lists for a JSON response (`tolist` of float32 gives the
    doubles that round-trip to the same float32)."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in payload.items()}


def _media_ranges(accept: str) -> dict[str, tuple[float, int]]:
    """Media type -> (its highest q, minus the position of its first
    range) in an Accept header; ranges with a q that does not parse are
    left out."""
    out: dict[str, tuple[float, int]] = {}
    for pos, part in enumerate(accept.split(",")):
        media, *params = (p.strip() for p in part.split(";"))
        q = 1.0
        for param in params:
            name, _, value = param.partition("=")
            if name.strip().lower() == "q":
                try:
                    q = float(value)
                except ValueError:
                    q = -1.0
        if media and q >= 0:
            best = out.get(media.lower())
            out[media.lower()] = (max(q, best[0]) if best else q,
                                  best[1] if best else -pos)
    return out


def _wants_npz(accept: str, binary_in: bool) -> bool:
    """Whether the response is npz: of npz and JSON, the one that
    `accept` names with the higher q above 0 (the earlier on a tie); the
    one it does not refuse where it refuses one (q=0); else the request's
    own format."""
    ranges = _media_ranges(accept)
    named = {t: ranges[t] for t in (NPZ_CONTENT_TYPE, JSON_CONTENT_TYPE)
             if t in ranges}
    acceptable = [t for t, (q, _) in named.items() if q > 0]
    if acceptable:
        return max(acceptable, key=named.get) == NPZ_CONTENT_TYPE
    if len(named) == 1:
        return JSON_CONTENT_TYPE in named
    return binary_in


def _as_array(obj, name: str) -> np.ndarray:
    if obj is None:
        raise ApiError(f"missing required field {name!r}")
    try:
        arr = np.asarray(obj, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ApiError(f"field {name!r} is not numeric: {e}") from e
    if arr.size == 0:
        raise ApiError(f"field {name!r} is empty")
    return arr


def _resolve_mask(engine: CounterfactualEngine, body: dict, batch: int,
                  x_shape):
    """The request's mask: a dense numpy array, or the engine's patch or
    feature mask as a tensor on its device; None for the default."""
    given = [k for k in ("mask", "patches", "features")
             if body.get(k) is not None]
    if len(given) > 1:
        raise ApiError(f"give at most one of mask/patches/features, got "
                       f"{given}")
    if not given:
        return None
    kind = given[0]
    if kind == "mask":
        mask = _as_array(body["mask"], "mask")
        want = tuple(x_shape[1:])
        if mask.shape not in (want, (batch,) + want):
            raise ApiError(
                f"mask shape {mask.shape} does not match sample shape {want}")
        return mask
    if kind == "patches":
        if engine.patch_size is None:
            raise ApiError("'patches' requires an image engine")
        patches = body["patches"]
        if (not isinstance(patches, list) or not patches
                or not all(isinstance(p, int) and not isinstance(p, bool)
                           for p in patches)):
            raise ApiError("'patches' must be a non-empty list of ints")
        hw = tuple(x_shape[1:3])
        n = (hw[0] // engine.patch_size) * (hw[1] // engine.patch_size)
        if any(p < 0 or p >= n for p in patches):
            raise ApiError(f"patch indices must be in [0, {n})")
        return engine.mask_from_patches(patches, batch, hw, x_shape[3])
    if engine.schema is None:
        raise ApiError("'features' requires a tabular engine")
    feats = body["features"]
    if not isinstance(feats, list) or not feats:
        raise ApiError("'features' must be a non-empty list of names")
    unknown = [f for f in feats if f not in engine.schema.feature_names]
    if unknown:
        raise ApiError(f"unknown feature names: {unknown}")
    return engine.mask_from_feature_names(feats, batch)


def _validate_x(engine: CounterfactualEngine, x: np.ndarray) -> None:
    """Reject a wrong rank or width as a 400 before the engine sees it."""
    if engine.schema is not None:  # tabular engine
        d = engine.schema.input_dim
        if x.ndim not in (1, 2) or x.shape[-1] != d:
            raise ApiError(
                f"'x' must be a {d}-feature vector or a batch of them "
                f"(got shape {x.shape})")
    elif engine.patch_size is not None:  # image engine
        if x.ndim not in (3, 4):
            raise ApiError(
                "'x' must be an (H, W, C) image or an (B, H, W, C) batch "
                f"— include the channel dim (got shape {x.shape})")
    elif x.ndim not in (1, 2):  # generic vector engine (moons)
        raise ApiError(
            f"'x' must be a feature vector or a batch of them "
            f"(got shape {x.shape})")


def _handle_classify(engine: CounterfactualEngine, body: dict) -> dict:
    x = _as_array(body.get("x"), "x")
    _validate_x(engine, x)
    probs = engine.classify(x)
    return {"probs": probs, "pred": np.argmax(probs, axis=1)}


def _parse_cf_request(engine: CounterfactualEngine, body: dict):
    """The counterfactual endpoints' validation: `(batched_x, targets,
    mask, key)`, or `ApiError`.  Targets are checked here, before the
    engine's own check would make a 500 of them."""
    x = _as_array(body.get("x"), "x")
    _validate_x(engine, x)
    target = body.get("target")
    if target is None:
        raise ApiError("missing required field 'target'")
    t = np.asarray(target)
    if t.dtype.kind not in "iu" or np.any(t < 0) or np.any(
            t >= engine.num_classes):
        raise ApiError(
            f"'target' must be int(s) in [0, {engine.num_classes})")
    # a single sample ((H, W, C) or (D,)) is a batch of one, as the
    # engine batches it; the masks see the batched shape
    batched_x = x[None] if x.ndim in (1, 3) else x
    if t.ndim > 1 or (t.ndim == 1 and t.shape[0] != batched_x.shape[0]):
        raise ApiError(
            f"'target' must be a scalar or length-{batched_x.shape[0]} list")
    mask = _resolve_mask(engine, body, batched_x.shape[0], batched_x.shape)
    seed = body.get("seed", 0)
    if not isinstance(seed, int) or isinstance(seed, bool):
        raise ApiError("'seed' must be an int")
    return batched_x, t, mask, jax_key(seed)


def _cf_payload(res) -> dict:
    # pred goes out as int32, the JAX server's npz dtype (jnp.argmax)
    return {"x_cf": res.x_cf, "residual": res.residual,
            "pred": res.pred.astype(np.int32),
            "confidence": res.confidence, "probs": res.probs,
            "probs_orig": res.probs_orig, "flipped": res.flipped}


def _handle_counterfactual(engine: CounterfactualEngine, body: dict) -> dict:
    batched_x, t, mask, key = _parse_cf_request(engine, body)
    return _cf_payload(engine.generate(batched_x, t, mask=mask, key=key))


def _handle_counterfactual_bulk(engine: CounterfactualEngine,
                                body: dict) -> dict:
    """`generate_bulk` over the wire: the request's rows in chunks of
    ``"chunk"`` (default 128), chunk i under `fold_in(key, i)`."""
    chunk = body.get("chunk", 128)
    if not isinstance(chunk, int) or isinstance(chunk, bool) \
            or not 1 <= chunk <= 65536:
        raise ApiError("'chunk' must be an int in [1, 65536]")
    batched_x, t, mask, key = _parse_cf_request(engine, body)
    try:
        res = engine.generate_bulk(batched_x, t, mask=mask, key=key,
                                   chunk=chunk)
    except ValueError as e:
        raise ApiError(str(e)) from e
    return _cf_payload(res)


ROUTES = {"/classify": _handle_classify,
          "/counterfactual": _handle_counterfactual,
          "/counterfactual_bulk": _handle_counterfactual_bulk}


class ApiStats:
    """Thread-safe per-endpoint request, error and sample counts, and
    latency quantiles over the last `WINDOW` requests, for ``/stats``."""

    WINDOW = 1024

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._errors = collections.Counter()
        self._samples = collections.Counter()
        self._lat = collections.defaultdict(
            lambda: collections.deque(maxlen=self.WINDOW))
        self._started = time.time()

    def record(self, path: str, seconds: float, samples: int, ok: bool):
        with self._lock:
            self._counts[path] += 1
            if not ok:
                self._errors[path] += 1
            self._samples[path] += samples
            self._lat[path].append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"uptime_s": round(time.time() - self._started, 1),
                   "endpoints": {}}
            for path in sorted(self._counts):
                lat = sorted(self._lat[path])

                def q(p, lat=lat):  # nearest rank over n - 1 intervals
                    return round(lat[int(round(p * (len(lat) - 1)))] * 1e3, 2)

                out["endpoints"][path] = {
                    "requests": self._counts[path],
                    "errors": self._errors[path],
                    "samples": self._samples[path],
                    "latency_ms": {"p50": q(0.50), "p95": q(0.95),
                                   "max": q(1.0)},
                }
            return out


class CFRequestHandler(BaseHTTPRequestHandler):
    """Routes requests to the server's engine, over HTTP/1.1 keep-alive
    connections (every response carries its Content-Length)."""

    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response is two writes (headers, body), and on a
    # kept-alive connection Nagle's algorithm holds the body back until
    # the client's delayed ACK of the headers (40 ms at least on Linux)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: D102
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: dict, binary: bool = False):
        if binary and code == 200:
            data, ctype = _encode_npz_payload(payload), NPZ_CONTENT_TYPE
        else:  # errors are always JSON
            data = json.dumps(_jsonable(payload)).encode()
            ctype = JSON_CONTENT_TYPE
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def do_GET(self):  # noqa: N802
        if self.path == "/stats":
            return self._send(200, self.server.stats.snapshot())
        if self.path != "/health":
            return self._send(404, {"error": f"unknown path {self.path}"})
        eng = self.server.engine
        kind = ("tabular" if eng.schema is not None
                else "image" if eng.patch_size is not None else "generic")
        self._send(200, {"status": "ok", "num_classes": eng.num_classes,
                         "kind": kind})

    def do_POST(self):  # noqa: N802
        handler = ROUTES.get(self.path)
        if handler is None:
            # read the body first: left in the socket, it would be read as
            # the next request on this connection
            self._read_body()
            return self._send(404, {"error": f"unknown path {self.path}"})
        t0 = time.perf_counter()
        samples, ok, binary_out = 0, False, False
        try:
            raw = self._read_body()
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            ctype = ctype.strip()
            binary_in = (ctype == NPZ_CONTENT_TYPE
                         or (ctype in ("", "application/octet-stream")
                             and raw[:4] == _ZIP_MAGIC))
            binary_out = _wants_npz(self.headers.get("Accept") or "",
                                    binary_in)
            if binary_in:
                body = _decode_npz_body(raw)
            else:
                body = json.loads(raw or b"{}")
                if not isinstance(body, dict):
                    raise ApiError("request body must be a JSON object")
            payload = handler(self.server.engine, body)
            samples = len(payload.get("pred", payload.get("probs", [])))
            ok = True
            out = (200, payload)
        except (ApiError, json.JSONDecodeError) as e:
            out = (400, {"error": str(e)})
        except Exception as e:
            out = (500, {"error": f"{type(e).__name__}: {e}"})
        # recorded before the response goes out: a client that has its
        # response sees the request in a later /stats
        self.server.stats.record(self.path, time.perf_counter() - t0,
                                 samples, ok)
        self._send(*out, binary=binary_out)


def make_server(engine: CounterfactualEngine, host: str = "127.0.0.1",
                port: int = 8000, verbose: bool = False
                ) -> ThreadingHTTPServer:
    """The API server, bound but not started (port 0 takes a free port):
    call `.serve_forever()`, in a thread of its own or not."""
    server = ThreadingHTTPServer((host, port), CFRequestHandler)
    server.engine = engine
    server.verbose = verbose
    server.stats = ApiStats()
    return server


def serve(engine: CounterfactualEngine, host: str = "127.0.0.1",
          port: int = 8000) -> None:
    """Serve until interrupted; prints the bound address first."""
    server = make_server(engine, host, port, verbose=True)
    print(f"cfgan API listening on http://{host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
