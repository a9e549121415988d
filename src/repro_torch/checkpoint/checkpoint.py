"""Checkpointing: npz-sharded save/restore of parameter trees.

The on-disk format is the reference's (``repro.checkpoint.checkpoint``), so
either package reads what the other wrote: flat key/value npz files plus a
JSON manifest holding every leaf's dtype and shape, the shard it lives in,
and free-form metadata. Shards are bounded at ``MAX_SHARD_BYTES``: leaves
are packed until a shard fills, and a leaf larger than the bound is split
into flat parts across consecutive shards (manifest ``parts``). npz holds
no bfloat16, so a bfloat16 leaf is stored widened to float32 (exact) with
its true dtype in the manifest, and narrowed back on restore (exact).

A tree is a nested dict (lists and tuples too) of torch tensors, on any
device, or numpy arrays; ``restore`` returns torch tensors.
:func:`elastic_manifest` records the worker pool's per-slot active mask and
u-history beside the master (a hierarchy adds its rack count, global
period and rack u-histories), and :func:`reseat_u_hist` re-seats those
histories into a pool of another capacity; :func:`reseat_group_hist` and
:func:`reseat_submasters` do the same for a hierarchy's racks at another
rack count. ``ElasticSession.save`` / ``restore`` drive them.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

_SEP = "/"
MAX_SHARD_BYTES = 1 << 30  # 1 GiB per npz shard
U_HIST_FILL = -30.0  # blank u-history entry (matches ElasticTrainer.init_state)
_NPZ_DTYPES = (np.float64, np.float32, np.float16, np.int64, np.int32,
               np.int16, np.int8, np.uint8, np.uint16, np.uint32, np.uint64,
               np.bool_)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k1, v in sorted(node.items()):
                walk(f"{prefix}{_SEP}{k1}" if prefix else str(k1), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{_SEP}{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)  # exact: npz holds no bfloat16
        return x.numpy()
    a = np.asarray(x)
    if a.dtype not in _NPZ_DTYPES:  # ml_dtypes (bfloat16, fp8) arrays
        a = a.astype(np.float32)
    return a


def _leaf_parts(arr: np.ndarray) -> List[np.ndarray]:
    """Split a leaf bigger than ``MAX_SHARD_BYTES`` into flat chunks (each
    at most one shard's worth); smaller leaves pass through whole."""
    if arr.nbytes <= MAX_SHARD_BYTES:
        return [arr]
    per = max(1, MAX_SHARD_BYTES // max(arr.itemsize, 1))
    flat = arr.reshape(-1)
    return [flat[i:i + per] for i in range(0, flat.size, per)]


def _sanitize(key: str) -> str:
    return key.replace(_SEP, "__")


def save(path: str, tree, *, metadata: Optional[dict] = None,
         collective: bool = False, group=None) -> None:
    """Write ``tree`` under the directory ``path``: the shards first, the
    manifest last (so a manifest implies complete shards).

    ``collective`` (a sharded run, whose master every rank holds): every
    rank of ``group`` (None: the default group) calls this, rank 0 writes,
    and all return once the checkpoint is complete."""
    if not collective:
        _write(path, tree, metadata)
        return
    try:
        if dist.get_rank(group) == 0:
            _write(path, tree, metadata)
    finally:
        dist.barrier(group=group)


def _write(path: str, tree, metadata: Optional[dict]) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = _flatten_with_paths(tree)
    keys_info: Dict[str, dict] = {}
    shards: List[dict] = []
    cur, cur_bytes = {}, 0

    def place(npz_key, arr):
        nonlocal cur, cur_bytes
        if cur_bytes + arr.nbytes > MAX_SHARD_BYTES and cur:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[npz_key] = arr
        cur_bytes += arr.nbytes
        return len(shards)  # index this npz_key will land in

    for key, leaf in leaves.items():
        arr = _to_numpy(leaf)
        parts = _leaf_parts(arr)
        info = {"dtype": _dtype_name(leaf), "shape": list(arr.shape)}
        if len(parts) == 1:
            info["shard"] = place(_sanitize(key), arr)
        else:  # oversized leaf: flat chunks across consecutive shards
            info["parts"] = [place(f"{_sanitize(key)}#p{j}", p)
                             for j, p in enumerate(parts)]
        keys_info[key] = info
    if cur:
        shards.append(cur)
    manifest = {"num_shards": len(shards), "keys": keys_info,
                "metadata": metadata or {}}
    for i, shard in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i:05d}.npz"), **shard)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def read_metadata(path: str) -> dict:
    """The checkpoint's metadata alone — no shard I/O."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["metadata"]


def read_fingerprint(path: str) -> Optional[str]:
    """Cheap change-detection token for pollers: the manifest's mtime_ns
    and size, no shard I/O; ``None`` while no manifest exists (``save``
    writes it last)."""
    try:
        st = os.stat(os.path.join(path, "manifest.json"))
    except OSError:
        return None
    return f"{st.st_mtime_ns}:{st.st_size}"


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf dtype {name!r} has no torch dtype")
    return dtype


def restore(path: str, like=None):
    """``(tree, metadata)``. Without ``like`` the tree holds CPU tensors in
    the manifest's dtypes; with ``like`` (a tree of tensors or arrays) it
    takes ``like``'s structure, and each leaf ``like``'s dtype and, for a
    tensor, its device. Split leaves are reassembled."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys = manifest["keys"]
    by_shard: Dict[int, list] = {}  # shard → [(npz key, key, part | None)]
    parts: Dict[str, list] = {}
    for k, info in keys.items():
        if "parts" in info:
            parts[k] = [None] * len(info["parts"])
            for j, s in enumerate(info["parts"]):
                by_shard.setdefault(s, []).append(
                    (f"{_sanitize(k)}#p{j}", k, j))
        else:
            by_shard.setdefault(info["shard"], []).append(
                (_sanitize(k), k, None))

    def as_tensor(arr, key):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(_torch_dtype(keys[key]["dtype"]))

    flat: Dict[str, torch.Tensor] = {}
    for i, entries in by_shard.items():
        with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
            for npz_key, k, j in entries:
                if j is None:
                    flat[k] = as_tensor(z[npz_key], k)
                else:
                    parts[k][j] = z[npz_key]
    for k, chunks in parts.items():
        flat[k] = as_tensor(np.concatenate(chunks).reshape(keys[k]["shape"]),
                            k)
    if like is None:
        return _unflatten_paths(flat), manifest["metadata"]
    out = {}
    for p, ref in _flatten_with_paths(like).items():
        if isinstance(ref, torch.Tensor):
            out[p] = flat[p].to(device=ref.device, dtype=ref.dtype)
        else:
            out[p] = flat[p].to(_torch_dtype(str(np.asarray(ref).dtype)))
    return _unflatten_into(like, out), manifest["metadata"]


# ---------------------------------------------------------------------------
# elastic worker-pool manifests
# ---------------------------------------------------------------------------

def elastic_manifest(active, u_hist, *, groups: Optional[int] = None,
                     global_period: Optional[int] = None,
                     g_u_hist=None) -> dict:
    """JSON-able per-slot record stored in checkpoint metadata: capacity,
    the live mask, and each slot's u-history window (worker params are
    not stored: a restore is a pool-wide rejoin from the master).
    Hierarchical runs add their topology and rack-level histories."""
    active = np.asarray(active, bool)
    u_hist = np.asarray(u_hist, np.float32)
    assert u_hist.shape[0] == active.shape[0]
    out = {"capacity": int(active.shape[0]),
           "active": active.astype(int).tolist(),
           "u_hist": [[float(v) for v in row] for row in u_hist]}
    if groups is not None:
        out["groups"] = int(groups)
        out["global_period"] = int(global_period or 1)
        if g_u_hist is not None:
            out["g_u_hist"] = [[float(v) for v in row]
                               for row in np.asarray(g_u_hist, np.float32)]
    return out


def reseat_u_hist(elastic_meta: Optional[dict], capacity: int, active_now,
                  window: int, fill: float = U_HIST_FILL) -> np.ndarray:
    """Re-seat a checkpoint's per-slot u-histories into a pool of
    ``capacity`` slots: the saved live slots map onto the active slots in
    order; the rest get blank (``fill``) histories; windows align on the
    newest entries. Returns the (capacity, window) float32 u-history."""
    out = np.full((capacity, window), fill, np.float32)
    if not elastic_meta:
        return out
    saved_active = np.asarray(elastic_meta.get("active", ()), bool)
    saved_hist = np.asarray(elastic_meta.get("u_hist", ()), np.float32)
    if saved_hist.ndim != 2 or saved_active.size != saved_hist.shape[0]:
        return out
    live = saved_hist[saved_active]
    w = min(window, live.shape[1]) if live.size else 0
    targets = np.flatnonzero(np.asarray(active_now, bool))
    m = min(len(live), len(targets))
    if m and w:
        out[targets[:m], window - w:] = live[:m, live.shape[1] - w:]
    return out


def reseat_group_hist(g_u_hist, n_groups: int, window: int,
                      fill: float = U_HIST_FILL) -> np.ndarray:
    """Re-seat a checkpoint's rack u-histories into ``n_groups`` racks: the
    first ``min(saved, n_groups)`` racks carry theirs across (racks are
    contiguous slot blocks under any count, so low racks map onto low
    racks), extra racks start blank; windows align on the newest entries.
    ``None`` or a malformed history (a flat checkpoint) gives all-blank.
    Returns the (n_groups, window) float32 ``g_u_hist``."""
    out = np.full((n_groups, window), fill, np.float32)
    if g_u_hist is None:
        return out
    g_u_hist = np.asarray(g_u_hist, np.float32)
    if g_u_hist.ndim != 2:
        return out
    g = min(n_groups, g_u_hist.shape[0])
    w = min(window, g_u_hist.shape[1])
    if g and w:
        out[:g, window - w:] = g_u_hist[:g, g_u_hist.shape[1] - w:]
    return out


def reseat_submasters(saved, master, n_groups: int):
    """Re-seat saved sub-masters into ``n_groups`` racks: rack g takes the
    saved rack g's sub-master while there is one, a master copy otherwise
    (a new rack starts from the master, like a joining worker);
    ``saved=None`` (a flat checkpoint) seats every rack from the master.
    ``saved`` and ``master`` are trees of one structure, of tensors or
    arrays; returns a tree of float32 tensors with a leading (n_groups,)
    axis, on the master leaves' device."""
    flat_m = _flatten_with_paths(master)
    flat_s = None if saved is None else _flatten_with_paths(saved)
    out = {}
    for p, m in flat_m.items():
        m = torch.as_tensor(m, dtype=torch.float32)
        seat = m.expand(n_groups, *m.shape).clone()
        if flat_s is not None:
            sm = torch.as_tensor(flat_s[p], dtype=torch.float32,
                                 device=m.device)
            g = min(n_groups, sm.shape[0])
            seat[:g] = sm[:g]
        out[p] = seat
    return _unflatten_into(master, out)


def _unflatten_paths(flat: Dict[str, Any]):
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(re.fullmatch(r"\d+", k) for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def _unflatten_into(like, flat_by_path):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}{_SEP}{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [walk(f"{prefix}{_SEP}{i}", v) for i, v in enumerate(node)]
            return type(node)(vals)
        return flat_by_path[prefix]

    return walk("", like)
