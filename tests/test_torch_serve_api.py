"""The port's HTTP API and client (`cfgan_torch.serve.api`, `.client`)
against the JAX package's (`cfgan.serve.api`, `cfgan.serve.client`), on
the CPU: both servers run side by side on loopback, each on its own
package's engine of the same model:

- the stub image engine (14x14, patch size 7) and the stub tabular engine
  (4 features, "d" immutable) of `tests/test_serve_api.py:172-260`, and
  the moons engine of the committed `results/moons_countergan/` run dir
  (both packages' `setup_moons`); the house engine for the seeds;
- every bad request gets the same status and the same error text from
  both (bar the three repairs below); every good one the same fields,
  npz dtypes and values, within 1e-5 (float32 matmuls in other orders);
  both wire formats;
- each package's client against the other's server;
- the JAX file's keep-alive, reconnect, hammer and `/stats` tests,
  mirrored on the port;
- the repairs of the JAX server, each shown next to the JAX server's
  behaviour: the unknown path's body drained before its 404, bool npz
  scalars rejected, `Accept` parsed with its q values, and TCP_NODELAY
  on the server's connections.
"""
import concurrent.futures
import http.client
import io
import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.core.config import TabularSchema as JaxSchema
from cfgan.serve.api import make_server as jax_make_server
from cfgan.serve.client import CFApiError as JaxApiError
from cfgan.serve.client import CFClient as JaxClient
from cfgan.serve.engine import CounterfactualEngine as JaxEngine
from cfgan.serve.launch import setup_house as jax_setup_house
from cfgan.serve.launch import setup_moons as jax_setup_moons
from cfgan_torch.core.config import TabularSchema
from cfgan_torch.serve import CFApiError, CFClient, CounterfactualEngine
from cfgan_torch.serve.api import NPZ_CONTENT_TYPE, make_server
from cfgan_torch.serve.launch import setup_house, setup_moons

ROOT = Path(__file__).resolve().parent.parent
H = W = 14
TOL = 1e-5
JSON = "application/json"

_rng = np.random.RandomState(0)
XM = _rng.rand(600, 2).astype(np.float32)  # moons points
XI = (_rng.rand(6, H, W, 1) * 2 - 1).astype(np.float32)  # images
XT = _rng.rand(8, 4).astype(np.float32)  # tabular rows
MASK_M = (_rng.rand(5, 2) > 0.5).astype(np.float32)


# ------------------------------------------------------------ engines
def _jax_image_engine():
    def cf_fn(g_vars, x, target, mask, key=None):
        raw = 0.2 * jnp.ones_like(x)
        return jnp.clip(x + raw * mask, -1, 1), raw, raw * mask

    wm = jax.random.normal(jax.random.key(0), (H * W, 4))

    def clf_fn(x):
        return x.reshape(x.shape[0], -1) @ wm

    return JaxEngine(cf_fn, clf_fn, {}, num_classes=4, patch_size=7), wm


def _port_image_engine(wm):
    wm = torch.from_numpy(np.array(wm))

    def cf_fn(x, target, mask, key=None):
        raw = 0.2 * torch.ones_like(x)
        return torch.clamp(x + raw * mask, -1, 1), raw, raw * mask

    def clf_fn(x):
        return x.reshape(x.shape[0], -1) @ wm

    return CounterfactualEngine(cf_fn, clf_fn, 4, patch_size=7,
                                device="cpu")


def _jax_tabular_engine():
    schema = JaxSchema(feature_names=("a", "b", "c", "d"),
                       immutable_features=("d",))

    def cf_fn(g_vars, x, target, mask, key=None):
        raw = 0.1 * jnp.ones_like(x)
        return x + raw * mask, raw, raw * mask

    def clf_fn(x):
        return jnp.stack([x[:, 0], x[:, 1], x[:, 2]], axis=1)

    return JaxEngine(cf_fn, clf_fn, {}, num_classes=3, schema=schema)


def _port_tabular_engine():
    schema = TabularSchema(feature_names=("a", "b", "c", "d"),
                           immutable_features=("d",))

    def cf_fn(x, target, mask, key=None):
        raw = 0.1 * torch.ones_like(x)
        return x + raw * mask, raw, raw * mask

    def clf_fn(x):
        return x[:, :3]

    return CounterfactualEngine(cf_fn, clf_fn, 3, schema=schema,
                                device="cpu")


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """kind -> (jax_base, port_base, jax_engine, port_engine)."""
    jimg, wm = _jax_image_engine()
    engines = {
        "moons": (jax_setup_moons(str(ROOT / "results/moons_countergan"))[0],
                  setup_moons(str(ROOT / "results/moons_countergan"),
                              device="cpu")[0]),
        "image": (jimg, _port_image_engine(wm)),
        "tabular": (_jax_tabular_engine(), _port_tabular_engine()),
    }
    started, out = [], {}
    for kind, (jeng, peng) in engines.items():
        js, ps = jax_make_server(jeng, port=0), make_server(peng, port=0)
        started += [js, ps]
        out[kind] = (_start(js), _start(ps), jeng, peng)
    yield out
    for s in started:
        s.shutdown()
        s.server_close()


# ----------------------------------------------------------- the wire
def _request(base, method, path, data=None, headers=None):
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _npz_bytes(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode(ctype, raw):
    if ctype == NPZ_CONTENT_TYPE:
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    return json.loads(raw)


def _post(base, path, body, wire="json", accept=None):
    """(status, content type, decoded body) of a POST in `wire`."""
    if wire == "npz":
        data = _npz_bytes(**{k: np.asarray(v) for k, v in body.items()})
        headers = {"Content-Type": NPZ_CONTENT_TYPE}
    else:
        data = json.dumps({k: (v.tolist() if isinstance(v, np.ndarray)
                               else v) for k, v in body.items()}).encode()
        headers = {"Content-Type": JSON}
    if accept is not None:
        headers["Accept"] = accept
    status, ctype, raw = _request(base, "POST", path, data, headers)
    return status, ctype, _decode(ctype, raw)


def _both(servers, kind, path, body, wire="json", accept=None):
    jbase, pbase, _, _ = servers[kind]
    return (_post(jbase, path, body, wire, accept),
            _post(pbase, path, body, wire, accept))


# ---------------------------------------------------- bad requests
BAD = [
    # tests/test_serve_api.py:107-127, on the moons engine
    ("moons", "/counterfactual", {}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]]}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 7}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 1.5}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": [0, 1]}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "mask": [1.0]}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "patches": [0]}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "features": ["grade"]}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "mask": [1.0, 1.0], "patches": [0]}),
    ("moons", "/counterfactual", {"x": "nope", "target": 0}),
    # the rest of the validation surface
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": -1}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": True}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "seed": "3"}),
    ("moons", "/counterfactual", {"x": [[0.1, 0.2]], "target": 0,
                                  "seed": True}),
    ("moons", "/counterfactual", {"x": [[[0.1, 0.2]]], "target": 1}),
    ("moons", "/counterfactual", {"x": [], "target": 1}),
    ("moons", "/classify", {"x": [[[0.1, 0.2]]]}),
    ("moons", "/classify", {}),
    ("moons", "/counterfactual_bulk", {"x": [[0.1, 0.2]], "target": 0,
                                       "chunk": 0}),
    ("moons", "/counterfactual_bulk", {"x": [[0.1, 0.2]], "target": 0,
                                       "chunk": True}),
    ("moons", "/counterfactual_bulk", {"x": [[0.1, 0.2]], "target": 0,
                                       "chunk": 70000}),
    ("moons", "/counterfactual_bulk", {"x": [[0.1, 0.2]]}),
    ("image", "/counterfactual", {"x": np.zeros((H, W)).tolist(),
                                  "target": 1}),
    ("image", "/counterfactual", {"x": XI[:1].tolist(), "target": 1,
                                  "patches": [99]}),
    ("image", "/counterfactual", {"x": XI[:1].tolist(), "target": 1,
                                  "patches": []}),
    ("image", "/counterfactual", {"x": XI[:1].tolist(), "target": 1,
                                  "patches": [True]}),
    ("image", "/counterfactual", {"x": XI[:1].tolist(), "target": 1,
                                  "features": ["a"]}),
    ("tabular", "/counterfactual", {"x": [[0.5] * 4], "target": 0,
                                    "features": ["zz"]}),
    ("tabular", "/counterfactual", {"x": [[0.5] * 3], "target": 0}),
    ("tabular", "/counterfactual", {"x": [[0.5] * 4], "target": 0,
                                    "features": []}),
    ("tabular", "/counterfactual", {"x": [[0.5] * 4], "target": 0,
                                    "features": "a"}),
    ("tabular", "/counterfactual", {"x": [[0.5] * 4], "target": 0,
                                    "patches": [0]}),
]


@pytest.mark.parametrize("kind,path,body", BAD,
                         ids=[f"{k}{p}-{i}" for i, (k, p, _) in
                              enumerate(BAD)])
def test_bad_requests_get_the_jax_status_and_text(servers, kind, path, body):
    (js, jc, jb), (ps, pc, pb) = _both(servers, kind, path, body)
    assert js == ps == 400
    assert jc == pc == JSON
    assert pb == jb and pb["error"]


@pytest.mark.parametrize("path,data,ctype", [
    ("/classify", b"{not json", JSON),
    ("/classify", b"[1, 2]", JSON),
    ("/counterfactual", b"PK\x03\x04garbage", NPZ_CONTENT_TYPE),
    ("/counterfactual", b"PK\x03\x04garbage", "application/octet-stream"),
    ("/counterfactual", _npz_bytes(x=XM[:2]), NPZ_CONTENT_TYPE),
    ("/counterfactual_bulk", _npz_bytes(x=XM[:2], target=np.int64(0),
                                        chunk=np.int64(0)),
     NPZ_CONTENT_TYPE),
], ids=["bad-json", "json-list", "npz-garbage", "octet-garbage",
        "npz-no-target", "npz-chunk"])
def test_bad_bodies_get_the_jax_status_and_text(servers, path, data, ctype):
    jbase, pbase, _, _ = servers["moons"]
    got = [_request(b, "POST", path, data, {"Content-Type": ctype})
           for b in (jbase, pbase)]
    (js, jc, jraw), (ps, pc, praw) = got
    assert js == ps == 400 and jc == pc == JSON
    assert json.loads(praw) == json.loads(jraw)


@pytest.mark.parametrize("method,path", [("POST", "/nope"),
                                         ("GET", "/nope"),
                                         ("GET", "/classify")])
def test_unknown_paths_are_404_with_the_jax_text(servers, method, path):
    jbase, pbase, _, _ = servers["moons"]
    data = b"{}" if method == "POST" else None
    got = [_request(b, method, path, data) for b in (jbase, pbase)]
    assert got[0][0] == got[1][0] == 404
    assert json.loads(got[0][2]) == json.loads(got[1][2])


@pytest.mark.parametrize("kind", ["moons", "image", "tabular"])
def test_health_is_the_jax_servers(servers, kind):
    jbase, pbase, _, _ = servers[kind]
    got = [json.loads(_request(b, "GET", "/health")[2])
           for b in (jbase, pbase)]
    assert got[0] == got[1]


# --------------------------------------------------- good requests
GOOD = [
    ("moons", "/classify", {"x": XM[:4]}),
    ("moons", "/classify", {"x": XM[0]}),
    ("moons", "/counterfactual", {"x": XM[:4], "target": 2}),
    ("moons", "/counterfactual", {"x": XM[0], "target": 1,
                                  "mask": np.zeros(2, np.float32)}),
    ("moons", "/counterfactual", {"x": XM[:3], "target": [0, 1, 2]}),
    ("moons", "/counterfactual", {"x": XM[:5], "target": 1, "mask": MASK_M}),
    ("moons", "/counterfactual", {"x": XM[:4], "target": 2, "seed": 7}),
    ("moons", "/counterfactual_bulk", {"x": XM[:20], "target": 2,
                                       "chunk": 8}),
    ("moons", "/counterfactual_bulk", {"x": XM[:5], "target": 1,
                                       "mask": np.zeros(2, np.float32)}),
    ("image", "/classify", {"x": XI[:3]}),
    ("image", "/counterfactual", {"x": XI[:2], "target": [1, 3]}),
    ("image", "/counterfactual", {"x": XI[0], "target": 2,
                                  "mask": np.zeros((H, W, 1), np.float32)}),
    ("image", "/counterfactual", {"x": XI[:2], "target": 1,
                                  "patches": [0]}),
    ("image", "/counterfactual_bulk", {"x": XI[:5], "target": 0, "chunk": 2,
                                       "patches": [1, 2]}),
    ("tabular", "/classify", {"x": XT[:3]}),
    ("tabular", "/counterfactual", {"x": XT[:2], "target": 0}),
    ("tabular", "/counterfactual", {"x": XT[:2], "target": 0,
                                    "features": ["a", "c"]}),
    ("tabular", "/counterfactual", {"x": XT[0], "target": 2,
                                    "features": ["d", "b"]}),
    ("tabular", "/counterfactual_bulk", {"x": XT[:6],
                                         "target": [0, 1, 2, 0, 1, 2],
                                         "chunk": 4}),
]
GOOD_WIRES = [(i, wire) for i, case in enumerate(GOOD)
              for wire in ("json", "npz")
              if wire == "json" or not ({"patches", "features"}
                                        & case[2].keys())]


def _assert_same_payload(got, want, wire):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if wire == "npz":
            assert g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case,wire", GOOD_WIRES,
                         ids=[f"{GOOD[i][0]}{GOOD[i][1]}-{i}-{w}"
                              for i, w in GOOD_WIRES])
def test_good_requests_get_the_jax_values(servers, case, wire):
    kind, path, body = GOOD[case]
    (js, jc, jb), (ps, pc, pb) = _both(servers, kind, path, body, wire)
    assert js == ps == 200 and jc == pc
    assert pc == (NPZ_CONTENT_TYPE if wire == "npz" else JSON)
    _assert_same_payload(pb, jb, wire)


def test_port_server_equals_its_engine_bit_for_bit(servers):
    """Both wire formats give the engine's own arrays, float32 through
    JSON included (`tolist` of float32 round-trips)."""
    _, pbase, _, peng = servers["moons"]
    want = peng.generate(XM[:64], 1)
    for wire in ("json", "npz"):
        _, _, body = _post(pbase, "/counterfactual",
                           {"x": XM[:64], "target": 1}, wire)
        for k in ("x_cf", "residual", "probs", "probs_orig", "confidence"):
            assert np.array_equal(np.asarray(body[k], np.float32),
                                  getattr(want, k)), (wire, k)
        assert np.array_equal(body["pred"], want.pred)


# ------------------------------------------------------ house seeds
@pytest.fixture(scope="module")
def house():
    run_dir = str(ROOT / "results" / "house_countergan")
    jeng, xte = jax_setup_house(run_dir)[:2]
    peng = setup_house(run_dir, device="cpu")[0]
    js, ps = jax_make_server(jeng, port=0), make_server(peng, port=0)
    yield _start(js), _start(ps), xte[:64]
    for s in (js, ps):
        s.shutdown()
        s.server_close()


@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 + 5])
@pytest.mark.parametrize("wire", ["json", "npz"])
def test_house_seed_gives_the_jax_servers_noise(house, seed, wire):
    """The request's seed is its key: the same seed gets the same Gumbel
    noise from both servers (2**32 + 5 keeps its low 32 bits, as JAX's
    key does with 64-bit mode off)."""
    jbase, pbase, x = house
    body = {"x": x, "target": np.arange(64) % 4, "seed": seed}
    got = [_post(b, "/counterfactual", body, wire) for b in (jbase, pbase)]
    assert got[0][0] == got[1][0] == 200
    _assert_same_payload(got[1][2], got[0][2], wire)


def test_house_features_mask_matches_jax(house):
    jbase, pbase, x = house
    body = {"x": x[:9], "target": 3, "seed": 11,
            "features": ["grade", "sqft_living", "lat"]}
    got = [_post(b, "/counterfactual_bulk", {**body, "chunk": 4})
           for b in (jbase, pbase)]
    assert got[0][0] == got[1][0] == 200
    _assert_same_payload(got[1][2], got[0][2], "json")


# -------------------------------------------------- cross-client
@pytest.mark.parametrize("wire", ["npz", "json"])
def test_jax_client_speaks_to_the_port_server(servers, wire):
    _, pbase, _, peng = servers["moons"]
    c = JaxClient(pbase, wire=wire)
    x = XM[:9]
    res = c.counterfactual(x, target=2)
    want = peng.generate(x, 2)
    assert np.array_equal(res.x_cf, want.x_cf)
    assert np.array_equal(res.probs, want.probs)
    assert np.array_equal(res.pred, want.pred)
    bulk = c.counterfactual_bulk(x, target=[0, 1, 2] * 3, chunk=4)
    want = peng.generate_bulk(x, np.asarray([0, 1, 2] * 3), chunk=4)
    assert np.array_equal(bulk.x_cf, want.x_cf)
    probs, pred = c.classify(x)
    assert np.array_equal(probs, peng.classify(x))
    assert c.health()["kind"] == "generic"
    assert "/classify" in c.stats()["endpoints"]
    with pytest.raises(JaxApiError) as ei:
        c.counterfactual(x, target=9)
    assert ei.value.status == 400 and "'target'" in ei.value.message


@pytest.mark.parametrize("wire", ["npz", "json"])
def test_port_client_speaks_to_the_jax_server(servers, wire):
    jbase, _, jeng, _ = servers["moons"]
    c = CFClient(jbase, wire=wire)
    x = XM[:9]
    res = c.counterfactual(x, target=2)
    want = jeng.generate(x, 2)
    assert np.array_equal(res.x_cf, want.x_cf)
    assert np.array_equal(res.probs, want.probs)
    assert np.array_equal(res.pred, want.pred)
    assert res.flipped.dtype == bool and res.probs.dtype == np.float32
    bulk = c.counterfactual_bulk(x, target=1, chunk=4)
    assert np.array_equal(bulk.x_cf, jeng.generate_bulk(x, 1, chunk=4).x_cf)
    probs, pred = c.classify(x)
    assert np.array_equal(probs, jeng.classify(x))
    assert np.array_equal(pred, np.argmax(probs, 1))
    assert c.health()["num_classes"] == 3
    with pytest.raises(CFApiError) as ei:
        c.counterfactual(x, target=9)
    assert ei.value.status == 400 and "'target'" in ei.value.message


@pytest.mark.parametrize("client_cls", [CFClient, JaxClient],
                         ids=["port-client", "jax-client"])
@pytest.mark.parametrize("server", [0, 1], ids=["jax-server", "port-server"])
def test_each_client_sends_patches_and_features_as_json(servers, client_cls,
                                                        server):
    """The list-valued masks go as JSON from an npz client, to either
    server: only patch 0 changes; only the allowed mutable features."""
    base = servers["image"][server]
    res = client_cls(base, wire="npz").counterfactual(
        np.zeros((2, H, W, 1), np.float32), target=1, patches=[0])
    assert np.abs(res.residual[:, 7:, :, :]).max() == 0.0
    assert np.abs(res.residual[:, :, 7:, :]).max() == 0.0
    assert np.abs(res.residual[:, :7, :7, :]).max() > 0.0
    base = servers["tabular"][server]
    res = client_cls(base, wire="npz").counterfactual(
        np.full((1, 4), 0.5, np.float32), target=0, features=["a", "c", "d"])
    np.testing.assert_allclose(res.x_cf[0] - 0.5, [0.1, 0.0, 0.1, 0.0],
                               atol=1e-7)


def test_port_client_rejects_two_masks_before_sending(servers):
    _, pbase, _, _ = servers["moons"]
    with pytest.raises(ValueError, match="at most one"):
        CFClient(pbase).counterfactual(XM[:2], target=1, mask=[0.0, 0.0],
                                       features=["a"])
    with pytest.raises(ValueError, match="wire"):
        CFClient(pbase, wire="xml")
    with pytest.raises(ValueError, match="base_url"):
        CFClient("ftp://host")


# --------------------------------------- mirrored: keep-alive & co
def test_client_keepalive_reuses_connection(servers):
    _, pbase, _, _ = servers["moons"]
    c = CFClient(pbase)
    c.health()
    conn = c._local.conn
    sock = conn.sock
    assert sock is not None  # still open after the response
    c.classify(XM[:2])
    c.counterfactual(XM[:2], target=1)
    assert c._local.conn is conn and conn.sock is sock
    c.close()
    assert c._local.conn is None


def test_client_reconnects_on_dead_socket(servers):
    _, pbase, _, _ = servers["moons"]
    c = CFClient(pbase)
    assert c.health()["status"] == "ok"
    c._local.conn.sock.close()  # as a server's idle close would
    probs, pred = c.classify(XM[:2])
    assert probs.shape == (2, 3) and pred.shape == (2,)


def test_concurrent_hammer_mixed_endpoints(servers):
    """8 threads x 6 requests mixing /classify and /counterfactual at
    batch sizes across bucket edges (1, 2, 127, 128, 129, 512, 513): each
    response bit-equals the engine's sequential answer."""
    _, pbase, _, peng = servers["moons"]
    sizes = [1, 2, 127, 128, 129, 512, 513]
    xs = {b: np.resize(XM, (b, 2)).astype(np.float32) for b in sizes}
    refs_cf = {b: peng.generate(xs[b], b % 3) for b in sizes}
    refs_pr = {b: peng.classify(xs[b]) for b in sizes}

    def worker(tid: int):
        order = np.random.RandomState(tid).permutation(
            len(sizes) * 2 - 1) % len(sizes)
        for j in order[:6]:
            b = sizes[j]
            if (tid + j) % 2:
                status, _, body = _post(pbase, "/classify", {"x": xs[b]})
                assert status == 200, body
                np.testing.assert_array_equal(
                    np.asarray(body["probs"], np.float32), refs_pr[b])
            else:
                status, _, body = _post(pbase, "/counterfactual",
                                        {"x": xs[b], "target": b % 3})
                assert status == 200, body
                np.testing.assert_array_equal(
                    np.asarray(body["x_cf"], np.float32), refs_cf[b].x_cf)
                assert body["pred"] == refs_cf[b].pred.tolist()
        return tid

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        done = list(pool.map(worker, range(8), timeout=300))
    assert done == list(range(8))


def test_stats_count_every_request_under_contention(servers):
    """16 client threads x 10 requests against a fresh server, with a
    short switch interval: /stats counts exactly 160 requests and their
    samples (a lost update would show)."""
    _, _, _, peng = servers["moons"]
    server = make_server(peng, port=0)
    base = _start(server)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(tid: int):
            c = CFClient(base, wire="npz" if tid % 2 else "json")
            for i in range(10):
                c.classify(XM[:1 + (tid + i) % 3])
            c.close()

        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
            list(pool.map(worker, range(16), timeout=300))
    finally:
        sys.setswitchinterval(interval)
    stats = CFClient(base).stats()["endpoints"]["/classify"]
    server.shutdown()
    server.server_close()
    assert stats["requests"] == 160 and stats["errors"] == 0
    assert stats["samples"] == sum(1 + (t + i) % 3 for t in range(16)
                                   for i in range(10))


def test_stats_endpoint_counts_and_latency(servers):
    _, pbase, _, _ = servers["moons"]
    _, _, before = _post(pbase, "/classify", {"x": XM[:1]})
    before = json.loads(_request(pbase, "GET", "/stats")[2])
    b_cf = before["endpoints"].get("/counterfactual",
                                   {"requests": 0, "errors": 0,
                                    "samples": 0})
    _post(pbase, "/counterfactual", {"x": XM[:3], "target": 1})
    _post(pbase, "/counterfactual", {"x": "garbage", "target": 1})  # 400
    _post(pbase, "/classify", {"x": XM[:2]})
    status, _, raw = _request(pbase, "GET", "/stats")
    after = json.loads(raw)
    assert status == 200 and after["uptime_s"] >= 0
    a_cf = after["endpoints"]["/counterfactual"]
    assert a_cf["requests"] == b_cf["requests"] + 2
    assert a_cf["errors"] == b_cf["errors"] + 1
    assert a_cf["samples"] == b_cf["samples"] + 3
    lat = a_cf["latency_ms"]
    assert lat["p50"] is not None and lat["p50"] <= lat["p95"] <= lat["max"]
    assert after["endpoints"]["/classify"]["requests"] >= 2


def test_npz_octet_stream_and_accept_json(servers):
    """An octet-stream zip body is read as npz; Accept turns the
    response format in either direction."""
    _, pbase, _, peng = servers["moons"]
    raw = _npz_bytes(x=XM[:2], target=np.int32(1))
    status, ctype, out = _request(pbase, "POST", "/counterfactual", raw,
                                  {"Content-Type": "application/octet-stream"})
    assert status == 200 and ctype == NPZ_CONTENT_TYPE
    assert _decode(ctype, out)["x_cf"].shape == (2, 2)
    status, ctype, out = _request(pbase, "POST", "/classify",
                                  json.dumps({"x": XM[:2].tolist()}).encode(),
                                  {"Content-Type": JSON,
                                   "Accept": NPZ_CONTENT_TYPE})
    assert status == 200 and ctype == NPZ_CONTENT_TYPE
    assert np.array_equal(_decode(ctype, out)["probs"], peng.classify(XM[:2]))


# ------------------------------------------ the JAX server's faults
def _post_then_health(base):
    """(status of POST /nope with a body, status of a GET /health on the
    same kept-alive connection)."""
    host, port = base.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/nope", body=b'{"x": 1}',
                     headers={"Content-Type": JSON})
        first = conn.getresponse()
        first.read()
        conn.request("GET", "/health")
        second = conn.getresponse()
        second.read()
        return first.status, second.status
    finally:
        conn.close()


def test_unknown_path_body_is_drained_before_the_404(servers):
    """The JAX server leaves the 404's body in the socket, where it is
    read as the next request line (a 400 for the next request); the
    port's reads it first, and the connection stays in step."""
    jbase, pbase, _, _ = servers["moons"]
    assert _post_then_health(jbase) == (404, 400)
    assert _post_then_health(pbase) == (404, 200)


@pytest.mark.parametrize("path,extra,frag", [
    ("/counterfactual", {"target": np.bool_(True)}, "'target' must be int"),
    ("/counterfactual", {"target": np.int64(1), "seed": np.bool_(True)},
     "'seed' must be an int"),
    ("/counterfactual_bulk", {"target": np.int64(1), "chunk": np.bool_(True)},
     "'chunk' must be an int"),
], ids=["target", "seed", "chunk"])
def test_npz_bool_scalars_are_rejected_as_json_bools_are(servers, path,
                                                         extra, frag):
    """The JAX server makes a 0-d bool npz entry an int and serves the
    request; the port's rejects it with the JSON path's 400."""
    jbase, pbase, _, _ = servers["moons"]
    body = {"x": XM[:2], **extra}
    assert _post(jbase, path, body, "npz")[0] == 200
    status, _, out = _post(pbase, path, body, "npz")
    assert status == 400 and frag in out["error"]
    as_json = {k: (v.item() if isinstance(v, np.generic) else v)
               for k, v in body.items()}
    (js, _, jb), (ps, _, pb) = _both(servers, "moons", path, as_json)
    assert js == ps == 400 and jb == pb == out


@pytest.mark.parametrize("accept,wire,jax_out,port_out", [
    ("application/json, application/x-npz;q=0.1", "npz", "npz", "json"),
    ("application/x-npz;q=0", "npz", "npz", "json"),
    ("application/x-npz;q=0.5, application/json;q=0.9", "json", "npz",
     "json"),
    ("application/json;q=0", "json", "json", "npz"),
    ("application/x-npz, application/json", "json", "npz", "npz"),
    ("application/json, application/x-npz", "npz", "npz", "json"),
    ("*/*", "npz", "npz", "npz"),
    ("", "json", "json", "json"),
    ("application/json", "npz", "json", "json"),
    ("application/x-npz", "json", "npz", "npz"),
], ids=["q-prefers-json", "npz-refused", "json-higher-q", "json-refused",
        "order-npz-first", "order-json-first", "wildcard", "none",
        "json", "npz"])
def test_accept_honours_q_and_order(servers, accept, wire, jax_out,
                                    port_out):
    """The JAX server matches Accept by substring; the port's takes the
    highest q above 0, the earlier range on a tie, and q=0 as a
    refusal (else the request's own format)."""
    ctype = {"npz": NPZ_CONTENT_TYPE, "json": JSON}
    (js, jc, _), (ps, pc, _) = _both(servers, "moons", "/counterfactual",
                                     {"x": XM[:2], "target": 1}, wire,
                                     accept)
    assert js == ps == 200
    assert (jc, pc) == (ctype[jax_out], ctype[port_out])


def test_server_connections_are_nodelay():
    """A response is two writes (headers, body): with Nagle's algorithm on
    (the JAX handler), a kept-alive connection's body waits for the
    client's delayed ACK (40 ms at least on Linux); the port's handler sets
    TCP_NODELAY on each connection it serves."""
    import socket

    from cfgan.serve.api import CFRequestHandler as JaxHandler
    from cfgan_torch.serve.api import CFRequestHandler

    assert JaxHandler.disable_nagle_algorithm is False
    assert CFRequestHandler.disable_nagle_algorithm is True
    seen = []

    class Probe(CFRequestHandler):
        def setup(self):
            super().setup()
            seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                                   socket.TCP_NODELAY))

    server = make_server(_port_tabular_engine(), port=0)
    server.RequestHandlerClass = Probe
    base = _start(server)
    try:
        assert CFClient(base).health()["kind"] == "tabular"
    finally:
        server.shutdown()
        server.server_close()
    assert seen and all(seen)
