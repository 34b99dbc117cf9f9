"""Run-dir checkpoints in the JAX package's format (mirrors
`cfgan/core/checkpoint.py`), without flax or msgpack.

A checkpoint is a directory holding `checkpoint.msgpack`, the flax
serialization of a tree of nested dicts (`flax.serialization.to_bytes`
of the JAX package's pytrees), and optionally `metadata.json`.  The
msgpack codec below covers what flax writes: maps, arrays, str, bin,
int, float, bool, nil, and flax's extension types 1 (an ndarray: the
msgpack of `(shape, dtype name, C-order bytes)`, bfloat16 included) and 3
(a numpy scalar, the same encoding).  Leaves decode to numpy arrays, and
bfloat16 leaves to `torch.bfloat16` tensors (numpy has no bfloat16); the
encoder takes numpy arrays and scalars and torch tensors.

`save_train_state` / `restore_train_state` write and read a whole
CounteRGAN train state in the layout of the JAX package's `GANState`, so
that either package resumes the other's run; a restore copies into the
live state in place (a captured CUDA graph keeps its addresses).
`save_sharded` / `restore_sharded` are the cooperative form for a state
replicated over a `torch.distributed` world: rank 0 writes, every rank
restores in place.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

FILE = "checkpoint.msgpack"
META = "metadata.json"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------------ encoder
def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit a msgpack integer")
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit a msgpack integer")


def _pack_len(n: int, fix: int | None, fix_max: int, codes, out: bytearray
              ) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"a msgpack object of length {n}")


def _array_bytes(a) -> tuple[tuple[int, ...], str, bytes]:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return (tuple(a.shape), "bfloat16",
                    a.view(torch.int16).numpy().tobytes())
        a = a.numpy()
    a = np.asarray(a)  # not ascontiguousarray, which makes 0-d arrays 1-d
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {a.dtype}")
    return tuple(a.shape), a.dtype.name, a.tobytes("C")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += data


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, Mapping):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map key {key!r}: flax trees have str keys")
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for value in obj:
            _pack(value, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, packb(_array_bytes(obj)), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, packb(_array_bytes(np.asarray(obj))), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of `obj`, as flax writes them (`use_bin_type`)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ------------------------------------------------------------------ decoder
class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def read(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B",
                   0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
                   0xDF: ">I"}
        if c in lengths:
            n = self.unpack(lengths[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            if c <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        raise ValueError(f"msgpack type byte {c:#x} is not supported")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _array(data: bytes):
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode()
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array(data)
    if code == _EXT_NPSCALAR:
        return _array(data)[()]
    raise ValueError(f"msgpack extension type {code} is not supported")


def _unchunk(tree):
    """flax splits leaves over 1 GiB into chunks; join them back."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """The tree that `packb` (or flax's `msgpack_serialize`) encoded."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


# --------------------------------------------------------------- run dirs
class _NumpyJSON(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def save(path: str, tree, metadata: dict[str, Any] | None = None) -> str:
    """Write `tree` (nested dicts of arrays) to the directory `path`."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, FILE), "wb") as f:
        f.write(packb(tree))
    if metadata is not None:
        with open(os.path.join(path, META), "w") as f:
            json.dump(metadata, f, cls=_NumpyJSON, indent=1)
    return path


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, FILE))


def load(path: str):
    """The tree in `path`'s checkpoint, as written."""
    with open(os.path.join(path, FILE), "rb") as f:
        return unpackb(f.read())


def _shape(a) -> tuple[int, ...] | None:
    return tuple(a.shape) if hasattr(a, "shape") else None


def _check_tree(got, want, where: str = "") -> None:
    """Raise ValueError unless `got` has `want`'s keys at every level and
    every array leaf of `want` has its shape in `got`."""
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(
                f"checkpoint at {where or '/'}: keys "
                f"{sorted(got) if isinstance(got, Mapping) else got!r} do "
                f"not match the template's {sorted(want)}")
        for key in want:
            _check_tree(got[key], want[key], f"{where}/{key}")
    elif _shape(want) is not None and _shape(got) != _shape(want):
        raise ValueError(f"checkpoint at {where}: leaf shape {_shape(got)} "
                         f"does not match template shape {_shape(want)}")


def restore(path: str, target):
    """The checkpoint's tree, held to the structure and leaf shapes of
    `target` (a template tree): a mis-shaped load raises here, not deep
    inside a step."""
    tree = load(path)
    _check_tree(tree, target, path)
    return tree


def load_metadata(path: str) -> dict[str, Any] | None:
    p = os.path.join(path, META)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def train_state_metadata(epoch: int, history: dict | None = None
                         ) -> dict[str, Any]:
    """The metadata of a mid-run checkpoint: the loop's position and its
    history."""
    meta: dict[str, Any] = {"epoch": int(epoch)}
    if history is not None:
        meta["history"] = {
            k: [float(v) for v in vs] if isinstance(vs, list) else float(vs)
            for k, vs in history.items()}
    return meta


def save_train_state(path: str, state, epoch: int,
                     history: dict | None = None) -> str:
    """Mid-run checkpoint of a whole train state (both networks'
    parameters and Adam states, the generator's BatchNorm statistics and
    EMA, the step count) and the loop's position: the run restored from
    it continues as the uninterrupted run does."""
    from cfgan_torch.convert import train_state_to_flax

    return save(path, train_state_to_flax(state),
                metadata=train_state_metadata(epoch, history))


def restore_train_state(path: str, state) -> tuple[int, dict]:
    """Copy a `save_train_state` checkpoint (of either package) into
    `state` in place; returns (next epoch, history)."""
    from cfgan_torch.convert import load_train_state, train_state_to_flax

    tree = restore(path, train_state_to_flax(state))
    load_train_state(state, tree)
    meta = load_metadata(path) or {}
    return int(meta.get("epoch", -1)) + 1, meta.get("history", {})


def _is_train_state(tree) -> bool:
    from cfgan_torch.train.state import GANState

    return isinstance(tree, GANState)


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_sharded(path: str, tree, metadata: dict[str, Any] | None = None
                 ) -> str:
    """The cooperative checkpoint of a replicated state
    (`cfgan.core.checkpoint.save_sharded`), called by every rank of the
    world: a train state is laid out as `save_train_state` lays it out
    (which the JAX package's `save_sharded` falls back to without orbax)
    on every rank, a channel-sharded net's slices gathered whole, so that
    the file is the replicated state's; rank 0 writes `save`'s format and
    every rank waits at a barrier until it is written."""
    if _is_train_state(tree):
        from cfgan_torch.convert import train_state_to_flax

        tree = train_state_to_flax(tree)
    if not dist.is_initialized() or dist.get_rank() == 0:
        save(path, tree, metadata)
    _barrier()
    return path


def restore_sharded(path: str, target):
    """`save_sharded`'s checkpoint, on every rank: a train state `target`
    is restored in place (a captured CUDA graph keeps its addresses; a
    channel-sharded net cuts its slices from the whole leaves) and
    returned; any other template gets the restored tree, as `restore`."""
    if not _is_train_state(target):
        return restore(path, target)
    from cfgan_torch.convert import load_train_state, train_state_to_flax

    load_train_state(target, restore(path, train_state_to_flax(target)))
    return target
