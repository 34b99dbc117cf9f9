"""Python client for the HTTP serving API (mirrors `cfgan/serve/client.py`),
standard library and numpy only; it speaks to the port's server and to the
JAX package's alike.

- ``wire="npz"`` (default): packed float32 ``application/x-npz`` bodies.
  The list-valued ``patches`` and ``features`` mask forms are JSON only
  on the wire, so a request that carries one goes as JSON (the response
  fields are the same either way).
- ``wire="json"``: JSON in and out.

Each thread holds one persistent HTTP/1.1 connection, and a request on a
kept-alive socket that died between calls is sent once more on a new one
(every request is a pure function of its body).  Responses come back as
the engine's `CFResult`::

    client = CFClient("http://127.0.0.1:8000")
    res = client.counterfactual_bulk(x, target=2, chunk=512)
    res.x_cf, res.flipped  # numpy arrays, as engine.generate_bulk gives

A non-2xx response raises `CFApiError` with the status and the server's
message.
"""
from __future__ import annotations

import http.client
import io
import json
import threading
import urllib.parse

import numpy as np

from cfgan_torch.serve.api import NPZ_CONTENT_TYPE
from cfgan_torch.serve.engine import CFResult


class CFApiError(RuntimeError):
    """Non-2xx API response: ``.status`` (int) and the server's message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _encode_npz(body: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in body.items()})
    return buf.getvalue()


def _decode_npz(raw: bytes) -> dict:
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class CFClient:
    """Client of one server.

    Args:
        base_url: e.g. ``"http://127.0.0.1:8000"``.
        wire: ``"npz"`` (default) or ``"json"``.
        timeout: socket timeout of a request, in seconds.
    """

    def __init__(self, base_url: str, wire: str = "npz",
                 timeout: float = 600.0):
        if wire not in ("npz", "json"):
            raise ValueError(f"wire must be 'npz' or 'json', got {wire!r}")
        self.base_url = base_url.rstrip("/")
        self.wire = wire
        self.timeout = timeout
        parts = urllib.parse.urlsplit(self.base_url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"base_url must be http(s)://host[:port], "
                             f"got {base_url!r}")
        self._conn_cls = (http.client.HTTPSConnection
                          if parts.scheme == "https"
                          else http.client.HTTPConnection)
        self._host, self._port = parts.hostname, parts.port
        self._path_prefix = parts.path.rstrip("/")
        self._local = threading.local()  # one connection per thread

    # -- transport ---------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._conn_cls(self._host, self._port,
                                  timeout=self.timeout)
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Close this thread's connection (the next call opens another)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _request(self, method: str, path: str, data: bytes | None = None,
                 ctype: str | None = None) -> dict:
        headers = {"Content-Type": ctype} if ctype else {}
        for attempt in (0, 1):  # once more on a dead kept-alive socket
            conn = self._conn()
            try:
                conn.request(method, self._path_prefix + path, body=data,
                             headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                break
            except TimeoutError:
                self.close()
                raise
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    raise
        status = resp.status
        resp_ctype = (resp.headers.get("Content-Type") or "").split(";")[0]
        if not 200 <= status < 300:
            try:
                message = json.loads(raw).get("error", "")
            except (ValueError, AttributeError):
                message = ""
            raise CFApiError(status, message)
        if resp_ctype == NPZ_CONTENT_TYPE:
            return _decode_npz(raw)
        return json.loads(raw)

    def _get(self, path: str) -> dict:
        return self._request("GET", path)

    def _post(self, path: str, body: dict) -> dict:
        json_only = any(k in body for k in ("patches", "features"))
        if self.wire == "npz" and not json_only:
            data, ctype = _encode_npz(body), NPZ_CONTENT_TYPE
        else:
            data = json.dumps(
                {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in body.items()}).encode()
            ctype = "application/json"
        return self._request("POST", path, data, ctype)

    # -- request assembly ---------------------------------------------
    @staticmethod
    def _cf_body(x, target, mask, patches, features, seed) -> dict:
        given = [k for k, v in
                 (("mask", mask), ("patches", patches),
                  ("features", features)) if v is not None]
        if len(given) > 1:
            raise ValueError(
                f"give at most one of mask/patches/features, got {given}")
        body = {"x": np.asarray(x, np.float32),
                "target": np.asarray(target)}
        if mask is not None:
            body["mask"] = np.asarray(mask, np.float32)
        if patches is not None:
            body["patches"] = [int(p) for p in patches]
        if features is not None:
            body["features"] = list(features)
        if seed is not None:
            body["seed"] = int(seed)
        return body

    @staticmethod
    def _cf_result(payload: dict) -> CFResult:
        a = {k: np.asarray(v) for k, v in payload.items()}
        return CFResult(
            x_cf=a["x_cf"].astype(np.float32, copy=False),
            residual=a["residual"].astype(np.float32, copy=False),
            pred=a["pred"],
            confidence=a["confidence"].astype(np.float32, copy=False),
            probs=a["probs"].astype(np.float32, copy=False),
            probs_orig=a["probs_orig"].astype(np.float32, copy=False),
            flipped=a["flipped"].astype(bool),
        )

    # -- endpoints ----------------------------------------------------
    def health(self) -> dict:
        """``GET /health``: the engine's kind and class count."""
        return self._get("/health")

    def stats(self) -> dict:
        """``GET /stats``: per-endpoint counts and latency quantiles."""
        return self._get("/stats")

    def classify(self, x) -> tuple[np.ndarray, np.ndarray]:
        """``POST /classify``: ``(probs (B, C), pred (B,))``."""
        out = self._post("/classify", {"x": np.asarray(x, np.float32)})
        return np.asarray(out["probs"], np.float32), np.asarray(out["pred"])

    def counterfactual(self, x, target, *, mask=None, patches=None,
                       features=None, seed=None) -> CFResult:
        """``POST /counterfactual``: one engine call.  ``x`` is a sample
        or a batch; ``target`` a class or one a sample; at most one of
        ``mask`` (dense, sample- or batch-shaped), ``patches`` (image
        engines) or ``features`` (tabular engines)."""
        body = self._cf_body(x, target, mask, patches, features, seed)
        return self._cf_result(self._post("/counterfactual", body))

    def counterfactual_bulk(self, x, target, *, chunk: int = 128,
                            mask=None, patches=None, features=None,
                            seed=None) -> CFResult:
        """``POST /counterfactual_bulk``: the engine's `generate_bulk`."""
        body = self._cf_body(x, target, mask, patches, features, seed)
        body["chunk"] = int(chunk)
        return self._cf_result(self._post("/counterfactual_bulk", body))
