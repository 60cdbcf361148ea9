"""Compressed on-disk model formats with verified reload.

The port of the JAX package's `storage/formats.py`; its files are the JAX
package's files, in both directions (the same entry names, the same
manifest, numpy arrays inside):

- sparse-zip: float32 tensors sparser than `sparse_threshold` stored as
  (flat indices, values) npy pairs, the rest npz-compressed, in one
  ZIP_DEFLATED container with a JSON manifest;
- gzip: the pickled {arrays, manifest} of numpy arrays, gzip-compressed
  (16 MiB pieces compressed in parallel, each a gzip member: one stream to
  any gzip reader);
- npz: every tensor through `np.savez_compressed`, the manifest beside.

Savers take a tree on any device (its leaves are copied to the host);
loaders rebuild the exact tree, QTensor leaves included, as contiguous
tensors on `device`. numpy has no bfloat16 or float8: such a leaf is
stored as the JAX package stores it, a flat uint8 view with its type
(`viewdtype`) and shape, and rebuilt with `Tensor.view`; an fp8 QTensor
field is stored as its bytes with an `__fp8` flag. `verify_roundtrip` is
the save → load → bit-equality check.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import pickle
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from ..models.params import DEFAULT_DEVICE, named_leaves, resolve_device
from ..ops.qtensor import QTensor

FORMAT_VERSION = 1
_GZIP_PIECE = 16 * 2 ** 20   # bytes of the pickle a gzip member holds
_QFIELDS = ("data", "scale", "zero", "scale2", "offset2", "act_scale")
# torch types with no numpy twin, by the name numpy's ml_dtypes gives them
_VIEW_DTYPES = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
                torch.float8_e5m2: "float8_e5m2"}
_FROM_VIEW = {v: k for k, v in _VIEW_DTYPES.items()}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _flatten(params: Any) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """-> ({storage name: numpy array}, manifest), the JAX package's layout:
    a QTensor expands into its array fields plus a manifest entry that
    rebuilds it; a leaf of a type numpy lacks becomes a flat uint8 view."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, Any] = {"version": FORMAT_VERSION, "leaves": {}}
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QTensor):
            fields: dict[str, Any] = {}
            for f in _QFIELDS:
                v = getattr(leaf, f)
                if v is None:
                    continue
                key = f"{name}::{f}"
                v = _host(v)
                if v.dtype == torch.float8_e4m3fn:
                    v = v.view(torch.uint8)
                    fields[f + "__fp8"] = True
                arrays[key] = v.numpy()
                fields[f] = key
            manifest["leaves"][name] = {
                "type": "qtensor", "fields": fields, "kind": leaf.kind,
                "bits": int(leaf.bits), "shape": [int(s) for s in leaf.shape],
                "block_size": int(leaf.block_size), "act": leaf.act,
            }
            continue
        t = _host(leaf)
        info: dict[str, Any] = {"type": "array", "dtype": None}
        if t.dtype in _VIEW_DTYPES:
            info["viewdtype"] = _VIEW_DTYPES[t.dtype]
            info["shape"] = list(t.shape)
            arr = t.reshape(-1).view(torch.uint8).numpy()
        else:
            arr = t.numpy()
        info["dtype"] = str(arr.dtype)
        arrays[name] = arr
        manifest["leaves"][name] = info
    return arrays, manifest


def _tensor(arr: np.ndarray, device: torch.device, view: str | None = None,
            shape: tuple | None = None) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if view is not None:
        t = t.reshape(-1).view(torch.uint8).view(_FROM_VIEW[view]).reshape(shape)
    return t.to(device).contiguous()


def _unflatten(arrays: dict[str, np.ndarray], manifest: dict[str, Any],
               device: torch.device) -> Any:
    params: dict = {}

    def ensure_path(name: str):
        parts = name.split(".")
        node: Any = params
        for i, part in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            if part.isdigit():
                idx = int(part)
                while len(node) <= idx:
                    node.append({})
                if not isinstance(node[idx], (dict, list)) or not node[idx]:
                    node[idx] = [] if nxt.isdigit() else {}
                node = node[idx]
            else:
                if not isinstance(node.get(part), (dict, list)):
                    node[part] = [] if nxt.isdigit() else {}
                node = node[part]
        return node, parts[-1]

    for name, info in manifest["leaves"].items():
        if info["type"] == "qtensor":
            kw = {}
            for f in _QFIELDS:
                key = info["fields"].get(f)
                if key is not None:
                    v = _tensor(arrays[key], device)
                    if info["fields"].get(f + "__fp8"):
                        v = v.view(torch.float8_e4m3fn)
                    kw[f] = v
            leaf = QTensor(kind=info["kind"], bits=info["bits"],
                           shape=tuple(info["shape"]),
                           block_size=info["block_size"],
                           act=info.get("act"), **kw)
        else:
            view = info.get("viewdtype")
            leaf = _tensor(arrays[name], device, view,
                           tuple(info["shape"]) if view else None)
        node, last = ensure_path(name)
        if isinstance(node, list):
            idx = int(last)
            while len(node) <= idx:
                node.append(None)
            node[idx] = leaf
        else:
            node[last] = leaf
    return params


def _sparsity(arr: np.ndarray) -> float:
    return float((arr == 0).mean()) if arr.size else 0.0


def _pool() -> ThreadPoolExecutor:
    """Threads for the compression (zlib releases the GIL)."""
    return ThreadPoolExecutor(min(8, os.cpu_count() or 1))


# ---------------------------------------------------------------------------
# sparse-zip
# ---------------------------------------------------------------------------

def save_sparse_zip(params: Any, path: str,
                    sparse_threshold: float = 0.7) -> dict[str, Any]:
    """ZIP container; per tensor: sparse (flat indices + values) when a
    float32 tensor's sparsity is above the threshold, else compressed npz,
    each entry compressed on a thread of its own. Returns {sparse_tensors,
    dense_tensors, file_mb}."""
    from ..runtime_native import sparse_encode

    arrays, manifest = _flatten(params)

    def entry(item) -> tuple[str, bytes]:
        key, arr = item
        safe = key.replace("::", "__Q__")
        buf = io.BytesIO()
        if arr.dtype == np.float32 and _sparsity(arr) > sparse_threshold:
            nz, vals = sparse_encode(arr.reshape(-1))
            np.savez_compressed(buf, indices=nz, values=vals,
                                shape=np.asarray(arr.shape),
                                dtype=np.asarray(str(arr.dtype)))
            return f"sparse/{safe}.npz", buf.getvalue()
        np.savez_compressed(buf, arr=arr)
        return f"dense/{safe}.npz", buf.getvalue()

    stats = {"sparse_tensors": 0, "dense_tensors": 0}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _pool() as pool, zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                                          compresslevel=9) as z:
        for key, (name, blob) in zip(arrays, pool.map(entry, arrays.items())):
            z.writestr(name, blob)
            if name.startswith("sparse/"):
                manifest["leaves_storage_" + key] = "sparse"
                stats["sparse_tensors"] += 1
            else:
                stats["dense_tensors"] += 1
        z.writestr("manifest.json", json.dumps(manifest))
    stats["file_mb"] = os.path.getsize(path) / (1024 ** 2)
    return stats


def load_sparse_zip(path: str, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    from ..runtime_native import sparse_decode

    device = resolve_device(device)
    arrays: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        for info in z.namelist():
            if info == "manifest.json":
                continue
            kind, fname = info.split("/", 1)
            key = fname[:-4].replace("__Q__", "::")
            data = np.load(io.BytesIO(z.read(info)), allow_pickle=False)
            if kind == "sparse":
                shape = tuple(int(s) for s in data["shape"])
                arrays[key] = sparse_decode(data["indices"], data["values"], shape
                                            ).astype(np.dtype(str(data["dtype"])))
            else:
                arrays[key] = data["arr"]
    return _unflatten(arrays, manifest, device)


# ---------------------------------------------------------------------------
# gzip
# ---------------------------------------------------------------------------

def save_gzip(params: Any, path: str, level: int = 9) -> dict[str, Any]:
    """The pickled {arrays, manifest} (numpy arrays only), gzip-compressed
    in pieces on parallel threads, each piece a gzip member (a reader of
    the format, `gzip.open` included, reads the members as one stream).
    Returns {file_mb, raw_mb}."""
    arrays, manifest = _flatten(params)
    payload = memoryview(pickle.dumps({"arrays": arrays, "manifest": manifest},
                                      protocol=pickle.HIGHEST_PROTOCOL))
    del arrays
    pieces = [payload[i: i + _GZIP_PIECE]
              for i in range(0, max(len(payload), 1), _GZIP_PIECE)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _pool() as pool, open(path, "wb") as f:
        for member in pool.map(lambda b: gzip.compress(b, level, mtime=0), pieces):
            f.write(member)
    return {"file_mb": os.path.getsize(path) / (1024 ** 2),
            "raw_mb": len(payload) / (1024 ** 2)}


def load_gzip(path: str, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    device = resolve_device(device)
    with gzip.open(path, "rb") as f:
        blob = pickle.loads(f.read())
    return _unflatten(blob["arrays"], blob["manifest"], device)


# ---------------------------------------------------------------------------
# npz-only
# ---------------------------------------------------------------------------

def save_npz(params: Any, path: str) -> dict[str, Any]:
    """Every array through `np.savez_compressed`, the manifest as the JSON
    string `__manifest__`. Returns {file_mb}."""
    arrays, manifest = _flatten(params)
    safe = {k.replace("::", "__Q__"): v for k, v in arrays.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __manifest__=np.asarray(json.dumps(manifest)),
                        **safe)
    return {"file_mb": os.path.getsize(path) / (1024 ** 2)}


def load_npz(path: str, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        arrays = {k.replace("__Q__", "::"): data[k] for k in data.files
                  if k != "__manifest__"}
    return _unflatten(arrays, manifest, device)


FORMATS = {
    "sparse_zip": (save_sparse_zip, load_sparse_zip),
    "gzip": (save_gzip, load_gzip),
    "npz": (save_npz, load_npz),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def leaves_equal(a, b) -> bool:
    """Bit equality of two leaves on any devices (compared on `a`'s): the
    dtype, shape and bytes of a tensor, or every field and attribute of a
    QTensor."""
    if isinstance(a, QTensor) or isinstance(b, QTensor):
        if not (isinstance(a, QTensor) and isinstance(b, QTensor)):
            return False
        if (a.kind, a.bits, tuple(a.shape), a.block_size, a.act) != (
                b.kind, b.bits, tuple(b.shape), b.block_size, b.act):
            return False
        return all((getattr(a, f) is None) == (getattr(b, f) is None)
                   and (getattr(a, f) is None or leaves_equal(getattr(a, f), getattr(b, f)))
                   for f in _QFIELDS)
    return (a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
            and torch.equal(_bits(a), _bits(b).to(a.device)))


def trees_equal(a: Any, b: Any) -> list[str]:
    """The names of the leaves where two trees differ (a leaf missing from
    either tree included); [] when every leaf is bit-equal."""
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    return sorted(set(la) ^ set(lb)) + [n for n in la if n in lb
                                         and not leaves_equal(la[n], lb[n])]


def verify_roundtrip(params: Any, path: str, fmt: str = "sparse_zip",
                     device: str | torch.device | None = None) -> dict:
    """save → load (onto `device`, by default the tree's own) → every leaf
    bit-equal (the JAX package compares QTensor codes and dense values)."""
    save, load = FORMATS[fmt]
    stats = save(params, path)
    if device is None:
        first = named_leaves(params)[0][1]
        device = (first.data if isinstance(first, QTensor) else first).device
    mismatches = trees_equal(params, load(path, device=device))
    return {"ok": not mismatches, "mismatches": mismatches, **stats}
