"""Erasure-coded sharded checkpoints with PR²-style pipelined restore.

The paper's read path, transplanted to checkpoint I/O, as the
reference's ``repro.checkpoint.ckpt``:

  * **ECC**: every shard carries a CRC32; a parity group of G shards
    carries one XOR parity shard, so any single lost or corrupt shard of
    a group is reconstructed (one failure per group is within margin);
  * **PR² (pipelining)**: a reader thread streams shard files into a
    bounded queue while the consumer verifies CRCs of the previous
    shard, so verification never blocks the next read;
  * **retry**: a shard failing verification is rebuilt from its parity
    group.

The on-disk layout is the reference's: leaves flattened in jax's order
(dict keys sorted at every level, list items in order), packed greedily
into shards of at most 16 MiB (a larger leaf is a shard of its own),
``shard_NNNNN.bin`` and ``parity_NNNNN.bin`` files, and a
``manifest.json`` with the same leaf, shard and parity records.  For the
same state the shard and parity files are byte-identical to the
reference's, and each package restores the other's checkpoints.  The
manifest holds the leaves' key paths (``"keys"``) where the reference
keeps jax's treedef proto.

Leaves are tensors (any device) or numpy arrays; ``bfloat16`` tensors
are stored as their 2-byte patterns under the dtype name ``bfloat16``
(what the reference's ``ml_dtypes`` arrays write).  Save streams one
shard at a time to disk; restore returns tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


@dataclasses.dataclass
class RestoreStats:
    """Observability for the restore pipeline."""

    read_s: float = 0.0            # wall time the reader thread spent in IO
    verify_s: float = 0.0          # CRC + reconstruction time (overlapped)
    wall_s: float = 0.0            # end-to-end restore wall time
    n_shards: int = 0
    n_reconstructed: int = 0       # parity reconstructions ("ECC corrections")
    n_failed: int = 0              # unrecoverable (should be 0)
    pipelined: bool = True


def flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` pairs in jax's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in flatten(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def unflatten_like(tree_like, leaves: Dict[str, Any],
                   prefix: Tuple[str, ...] = ()):
    """``tree_like``'s structure with each leaf taken from ``leaves`` by
    its key path."""
    if isinstance(tree_like, dict):
        return {k: unflatten_like(v, leaves, prefix + (str(k),))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return [unflatten_like(v, leaves, prefix + (str(i),))
                for i, v in enumerate(tree_like)]
    return leaves["/".join(prefix)]


def _unflatten_keys(leaves: Dict[str, Any]) -> dict:
    """Nested dicts from key paths (a checkpoint restored without a
    template)."""
    out: dict = {}
    for key, leaf in leaves.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _leaf_bytes(leaf) -> Tuple[bytes, str, List[int]]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16", \
                list(t.shape)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def save(dirpath, tree: Any, *, shard_bytes: int = 1 << 24,
         parity_group: int = 4) -> Path:
    """Serialize nested dicts / lists of tensors into CRC'd shards +
    XOR parity, one shard in memory at a time."""
    dirpath = Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    records: List[Dict] = []
    shard_meta: List[Dict] = []
    parity_meta: List[Dict] = []
    state = {"cur": bytearray(), "parity": None, "members": []}

    def flush_parity():
        acc = state["parity"]
        f = dirpath / f"parity_{len(parity_meta):05d}.bin"
        f.write_bytes(acc.tobytes())
        parity_meta.append({"file": f.name, "members": state["members"],
                            "size": len(acc), "crc32": zlib.crc32(acc)})
        state["parity"], state["members"] = None, []

    def flush_shard():
        blob = bytes(state["cur"])
        sid = len(shard_meta)
        f = dirpath / f"shard_{sid:05d}.bin"
        f.write_bytes(blob)
        shard_meta.append({"file": f.name, "size": len(blob),
                           "crc32": zlib.crc32(blob)})
        buf = np.frombuffer(blob, np.uint8)
        acc = state["parity"]
        if acc is None or len(acc) < len(buf):
            grown = np.zeros(len(buf), np.uint8)
            if acc is not None:
                grown[:len(acc)] = acc
            acc = grown
        acc[:len(buf)] ^= buf
        state["parity"] = acc
        state["members"].append(sid)
        state["cur"] = bytearray()
        if len(state["members"]) == parity_group:
            flush_parity()

    keys = []
    for key, leaf in flatten(tree):
        data, dtype, shape = _leaf_bytes(leaf)
        if state["cur"] and len(state["cur"]) + len(data) > shard_bytes:
            flush_shard()
        records.append({"key": key, "shape": shape, "dtype": dtype,
                        "shard": len(shard_meta),
                        "offset": len(state["cur"]), "size": len(data)})
        state["cur"].extend(data)
        keys.append(key)
    flush_shard()
    if state["members"]:
        flush_parity()
    manifest = {"keys": keys, "leaves": records, "shards": shard_meta,
                "parity": parity_meta, "parity_group": parity_group}
    (dirpath / MANIFEST).write_text(json.dumps(manifest))
    return dirpath


def _read_shard(dirpath: Path, meta: Dict) -> Optional[bytes]:
    f = dirpath / meta["file"]
    return f.read_bytes() if f.exists() else None


def _verify(meta: Dict, data: Optional[bytes]) -> bool:
    return (data is not None and len(data) == meta["size"]
            and zlib.crc32(data) == meta["crc32"])


def _reconstruct(dirpath: Path, manifest: Dict, sid: int,
                 have: Dict[int, bytes]) -> Optional[bytes]:
    """XOR-reconstruct shard ``sid`` from its parity group."""
    group = next((g for g in manifest["parity"] if sid in g["members"]),
                 None)
    if group is None or not (dirpath / group["file"]).exists():
        return None
    acc = np.frombuffer((dirpath / group["file"]).read_bytes(),
                        np.uint8).copy()
    for m in group["members"]:
        if m == sid:
            continue
        data = have.get(m)
        if data is None:
            data = _read_shard(dirpath, manifest["shards"][m])
        if data is None or not _verify(manifest["shards"][m], data):
            return None  # two failures in one group exceed the margin
        buf = np.frombuffer(data, np.uint8)
        acc[:len(buf)] ^= buf
    out = bytes(acc[:manifest["shards"][sid]["size"]])
    return out if _verify(manifest["shards"][sid], out) else None


def restore(dirpath, tree_like: Any = None, *, pipelined: bool = True,
            queue_depth: int = 2, device=None) -> Tuple[Any, RestoreStats]:
    """Restore a checkpoint of :func:`save` (or the reference's) into
    ``tree_like``'s structure (``None``: nested dicts from the key
    paths), as tensors on ``device`` (``None``: the CPU).

    ``pipelined=False`` serializes read -> verify per shard (the
    "regular read-retry" baseline).
    """
    dirpath = Path(dirpath)
    manifest = json.loads((dirpath / MANIFEST).read_text())
    stats = RestoreStats(pipelined=pipelined,
                         n_shards=len(manifest["shards"]))
    t_wall = time.perf_counter()
    blobs: Dict[int, bytes] = {}

    def check(sid, data):
        t0 = time.perf_counter()
        if not _verify(manifest["shards"][sid], data):
            data = _reconstruct(dirpath, manifest, sid, blobs)
            if data is None:
                stats.n_failed += 1
            else:
                stats.n_reconstructed += 1
        if data is not None:
            blobs[sid] = data
        stats.verify_s += time.perf_counter() - t0

    if pipelined:
        q: "queue.Queue" = queue.Queue(maxsize=queue_depth)

        def reader():
            t = 0.0
            for sid, meta in enumerate(manifest["shards"]):
                t0 = time.perf_counter()
                data = _read_shard(dirpath, meta)
                t += time.perf_counter() - t0
                q.put((sid, data))
            q.put((None, t))

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        while True:
            sid, data = q.get()
            if sid is None:
                stats.read_s = data
                break
            check(sid, data)
        th.join()
    else:
        for sid, meta in enumerate(manifest["shards"]):
            t0 = time.perf_counter()
            data = _read_shard(dirpath, meta)
            stats.read_s += time.perf_counter() - t0
            check(sid, data)

    if stats.n_failed:
        raise IOError(f"unrecoverable checkpoint: {stats.n_failed} shard(s) "
                      f"beyond parity margin in {dirpath}")
    dev = torch.device(device) if device is not None else None
    leaves = {}
    for r in manifest["leaves"]:
        raw = blobs[r["shard"]][r["offset"]:r["offset"] + r["size"]]
        t = _from_bytes(raw, r["dtype"], r["shape"])
        leaves[r["key"]] = t.to(dev) if dev is not None else t
    tree = _unflatten_keys(leaves) if tree_like is None \
        else unflatten_like(tree_like, leaves)
    stats.wall_s = time.perf_counter() - t_wall
    return tree, stats


# -- failure injection (tests and the fault-tolerance checks) ------------------


def corrupt_shard(dirpath, sid: int, nbytes: int = 64) -> None:
    """Flip bytes mid-shard (silent corruption -> CRC catches it)."""
    f = Path(dirpath) / f"shard_{sid:05d}.bin"
    data = bytearray(f.read_bytes())
    mid = max(len(data) // 2 - nbytes // 2, 0)
    for i in range(mid, min(mid + nbytes, len(data))):
        data[i] ^= 0xFF
    f.write_bytes(bytes(data))


def delete_shard(dirpath, sid: int) -> None:
    """Simulate a lost node's shard file."""
    (Path(dirpath) / f"shard_{sid:05d}.bin").unlink()
