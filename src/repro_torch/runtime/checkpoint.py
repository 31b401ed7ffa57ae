"""Checkpoint/restart, byte-compatible with the reference's on-disk format.

Port of ``repro.runtime.checkpoint``.  Layout (one directory per step)::

    <root>/step_000123/
        manifest.json          # tree structure, shapes, dtypes, step meta
        arr_000000.npy ...     # one file per leaf (copied to the host)
        _COMPLETE              # written LAST -> crash-safe commit marker

  * atomic commit: everything is written into ``<dir>.tmp`` then renamed;
    readers only trust directories containing ``_COMPLETE``.
  * per-partition checkpoints: each partition saves its own tree under
    ``partition_<k>/`` and a failed node restores and retrains alone.
  * retention: the ``keep`` newest checkpoints are kept, older ones pruned.
  * delta checkpoints: ``save_delta`` stores per-leaf sparse ROW diffs
    against a committed base step (``idx_*.npy`` + ``rows_*.npy``; a full
    per-leaf copy when the diff is dense or the shape changed) and
    ``restore_delta`` resolves the chain, refusing a base that is missing
    or no longer the manifest the delta was diffed against (sha256).

A checkpoint either package writes restores in the other, leaf for leaf:
the leaves are flattened in the reference's order (a NamedTuple's fields
in order, a dict's keys SORTED, ``None`` holds no leaf) and the manifest's
``treedef`` is the reference's string for the same tree, which
``save_delta`` compares against its base's.  ``restore`` rebuilds the
template's containers with tensors on ``device=`` (the reference's
``shardings=`` has no meaning on one card).  A bfloat16 leaf (the LM
trainer's parameters) is written as the reference's ``np.save`` writes an
``ml_dtypes`` bfloat16 array -- descr ``'<V2'``, the raw bits, manifest
dtype "bfloat16" -- and restored as ``torch.bfloat16`` bit for bit, from
either package's files (the reference itself cannot restore such a leaf:
jax rejects the ``V2`` array numpy loads).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import as_numpy, check_device


# ---------------------------------------------------------------------------
# Tree flattening in the reference's leaf order
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


class _TreeDef:
    """The structure of a flattened tree: ``kind`` is "leaf", "none",
    "tuple", "list", "dict" or "namedtuple"; ``meta`` the dict's keys (as
    the template ordered them) or the NamedTuple class."""
    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind, meta=None, children=()):
        self.kind, self.meta, self.children = kind, meta, tuple(children)

    def _body(self) -> str:
        kids = [c._body() for c in self.children]
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "tuple":
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") \
                + ")"
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        if self.kind == "dict":
            pairs = zip(sorted(self.meta), kids)
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in pairs) + "}"
        return (f"CustomNode(namedtuple[{self.meta.__name__}], ["
                + ", ".join(kids) + "])")

    def __str__(self):
        """The reference's ``str(treedef)`` for the same tree."""
        return f"PyTreeDef({self._body()})"

    def unflatten(self, leaves: List[Any]):
        return self._build(iter(leaves))

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "tuple":
            return tuple(kids)
        if self.kind == "list":
            return kids
        if self.kind == "dict":
            by_key = dict(zip(sorted(self.meta), kids))
            return {k: by_key[k] for k in self.meta}
        return self.meta(*kids)


def _walk(x, leaves: List[Any]) -> _TreeDef:
    """``x``'s treedef, its leaves appended to ``leaves``.  (A module-level
    function: a nested recursive closure over ``leaves`` would make a
    reference cycle that keeps every leaf alive until the next garbage
    collection -- gigabytes of gradients on the card.)"""
    if x is None:
        return _TreeDef("none")
    if _is_namedtuple(x):
        return _TreeDef("namedtuple", type(x), [_walk(c, leaves) for c in x])
    if isinstance(x, tuple):
        return _TreeDef("tuple", None, [_walk(c, leaves) for c in x])
    if isinstance(x, list):
        return _TreeDef("list", None, [_walk(c, leaves) for c in x])
    if isinstance(x, dict):
        return _TreeDef("dict", list(x), [_walk(x[k], leaves) for k in sorted(x)])
    leaves.append(x)
    return _TreeDef("leaf")


def tree_flatten(tree) -> Tuple[List[Any], _TreeDef]:
    """-> (leaves, treedef), leaves in ``jax.tree.flatten``'s order."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])


#: a bfloat16 leaf on the host: its raw bits as 2-byte voids.  On disk it is
#: what the reference's ``np.save`` writes for an ``ml_dtypes`` bfloat16
#: array: the ``.npy`` descr ``'<V2'``, the little-endian bits, and
#: "bfloat16" as the manifest's dtype (``ml_dtypes`` is not needed).
_BF16_HOST = np.dtype("V2")
_BF16_DESCR = "<V2"


def _leaf_to_numpy(leaf, i: int) -> np.ndarray:
    """A leaf as the host array the reference would save (a bfloat16 tensor
    as ``_BF16_HOST``).  A tensor whose dtype has no such form (fp8) raises:
    it is never cast quietly."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view(_BF16_HOST)
        try:
            return leaf.cpu().numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {i}: dtype {leaf.dtype} has no numpy "
                "counterpart; cast it explicitly before saving") from e
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype string for a host leaf (the reference's)."""
    return "bfloat16" if arr.dtype == _BF16_HOST else str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray):
    """``np.save``, except that a bfloat16 leaf gets the reference's header
    (descr ``'<V2'``; numpy alone would write ``'|V2'``)."""
    if arr.dtype != _BF16_HOST:
        np.save(path, arr)
        return
    arr = np.asarray(arr, order="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        arr.tofile(f)


def _to_tensor(arr: np.ndarray, dtype: str, i: int) -> torch.Tensor:
    """A loaded leaf -> a CPU tensor.  A 2-byte void leaf the manifest calls
    "bfloat16" (the reference's bf16, or the port's) comes back as
    ``torch.bfloat16``, bit for bit; any other dtype numpy reads only as
    voids (fp8) raises."""
    if arr.dtype.kind == "V":
        if dtype == "bfloat16" and arr.dtype.itemsize == 2:
            bits = np.asarray(arr, order="C").view(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16)
        raise TypeError(f"checkpoint leaf {i}: dtype {dtype!r} has no torch "
                        "counterpart here")
    return torch.from_numpy(arr)


def _to_device(treedef, arrs, manifest, device):
    dev = check_device(device)
    return treedef.unflatten([
        _to_tensor(a, meta["dtype"], i).to(dev)
        for i, (a, meta) in enumerate(zip(arrs, manifest["leaves"]))])


# ---------------------------------------------------------------------------
# Shape-free templates
# ---------------------------------------------------------------------------


class _Unshaped:
    """Shape-free template leaf: ``restore`` checks leaf shapes against the
    ``like`` template only when the template leaf HAS a shape, so a tree of
    these sentinels restores whatever the checkpoint holds (the serving
    idiom: a merged model's capacity is a training outcome)::

        g, extra, step = mgr.restore_latest(unshaped_like(Gaussians))

    Structure (leaf count / order) is still asserted; only shapes float."""
    __slots__ = ()

    def __repr__(self):
        return "UNSHAPED"


UNSHAPED = _Unshaped()


def unshaped_like(structure):
    """A tree of ``UNSHAPED`` sentinels matching ``structure``: a template
    tree (leaf values ignored) or a NamedTuple CLASS with only array fields
    (e.g. ``core.gaussians.Gaussians``)."""
    if isinstance(structure, type) and issubclass(structure, tuple) \
            and hasattr(structure, "_fields"):
        return structure(*([UNSHAPED] * len(structure._fields)))
    return tree_map(lambda _: UNSHAPED, structure)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dir(self, step: int, partition: Optional[int] = None) -> str:
        d = os.path.join(self.root, f"step_{step:09d}")
        if partition is not None:
            d = os.path.join(d, f"partition_{partition}")
        return d

    @staticmethod
    def _commit(tmp: str, final: str, manifest: dict):
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write("ok")
        os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    @staticmethod
    def _fresh_tmp(final: str) -> str:
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        return tmp

    def save(self, step: int, tree: Any, *, partition: Optional[int] = None,
             extra: Optional[dict] = None):
        """Copy every leaf to the host and atomically write one checkpoint.
        ``extra`` is a JSON-able dict stored in manifest.json verbatim (the
        trainer rides its TierSchedule state on ``extra["schedule"]``)."""
        final = self._step_dir(step, partition)
        tmp = self._fresh_tmp(final)
        leaves, treedef = tree_flatten(tree)
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "extra": extra or {},
            "leaves": [],
        }
        for i, leaf in enumerate(leaves):
            arr = _leaf_to_numpy(leaf, i)
            _save_leaf(os.path.join(tmp, f"arr_{i:06d}.npy"), arr)
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": _dtype_name(arr)})
        self._commit(tmp, final, manifest)
        self._prune()
        return final

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)

    def all_steps(self, partition: Optional[int] = None):
        """Complete checkpoint steps, ascending.  ``partition=None`` counts
        a step complete when the root OR any partition subtree committed
        (retention semantics); ``partition=k`` counts only steps where THAT
        partition's own subtree committed."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            d = os.path.join(self.root, name)
            if partition is not None:
                complete = os.path.exists(os.path.join(
                    d, f"partition_{partition}", "_COMPLETE"))
            else:
                complete = os.path.exists(os.path.join(d, "_COMPLETE")) \
                    or any(
                        os.path.exists(os.path.join(d, p, "_COMPLETE"))
                        for p in os.listdir(d) if p.startswith("partition_")
                    )
            if complete:
                out.append(int(name[5:]))
        return out

    def latest_step(self, partition: Optional[int] = None) -> Optional[int]:
        steps = self.all_steps(partition)
        return steps[-1] if steps else None

    def latest_restorable_step(self,
                               partition: Optional[int] = None
                               ) -> Optional[int]:
        """Newest step whose EXACT target tree committed: the root tree for
        ``partition=None``, that partition's subtree otherwise."""
        for s in reversed(self.all_steps(partition)):
            if os.path.exists(os.path.join(self._step_dir(s, partition),
                                           "_COMPLETE")):
                return s
        return None

    def manifest_extra(self, step: int,
                       partition: Optional[int] = None) -> dict:
        """The ``extra`` dict of a committed checkpoint WITHOUT restoring
        its tree (the resume-compatibility peek)."""
        d = self._step_dir(step, partition)
        assert os.path.exists(os.path.join(d, "_COMPLETE")), d
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["extra"]

    def restore_latest(self, like: Any, *, partition: Optional[int] = None,
                       device="cuda"):
        """Restore the newest RESTORABLE checkpoint: (tree, extra, step).
        None restorable (for THIS tree/partition) -> ``(like, {}, None)``."""
        step = self.latest_restorable_step(partition)
        if step is None:
            return like, {}, None
        tree, extra = self.restore(step, like, partition=partition,
                                   device=device)
        return tree, extra, step

    @staticmethod
    def _check_like(like, manifest, shapes):
        leaves, treedef = tree_flatten(like)
        assert len(leaves) == manifest["n_leaves"], (
            f"leaf count mismatch: have {len(leaves)}, "
            f"checkpoint {manifest['n_leaves']}")
        for i, (ref, shape) in enumerate(zip(leaves, shapes)):
            want = tuple(ref.shape) if hasattr(ref, "shape") else None
            assert want is None or want == shape, (
                f"leaf {i}: shape {shape} != expected {want}")
        return treedef

    def restore(self, step: int, like: Any, *,
                partition: Optional[int] = None, device="cuda"):
        """Restore into the structure of ``like`` -> (tree, extra), every
        leaf a tensor on ``device``."""
        d = self._step_dir(step, partition)
        assert os.path.exists(os.path.join(d, "_COMPLETE")), d
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if "delta" in manifest:
            raise ValueError(
                f"checkpoint step {step} under {self.root} is a DELTA "
                "checkpoint (diffed against base step "
                f"{manifest['delta']['base_step']}); restore it with "
                "restore_delta, which resolves the base chain")
        arrs = [np.load(os.path.join(d, f"arr_{i:06d}.npy"))
                for i in range(manifest["n_leaves"])]
        treedef = self._check_like(like, manifest, [a.shape for a in arrs])
        return _to_device(treedef, arrs, manifest, device), manifest["extra"]

    # -- delta checkpoints --------------------------------------------------

    def _manifest_digest(self, step: int,
                         partition: Optional[int] = None) -> str:
        """sha256 of a committed checkpoint's raw manifest.json bytes."""
        path = os.path.join(self._step_dir(step, partition), "manifest.json")
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def save_delta(self, step: int, tree: Any, *, base_step: int,
                   partition: Optional[int] = None,
                   extra: Optional[dict] = None):
        """Atomically write ``tree`` as a DELTA against the committed
        checkpoint at ``base_step``: per-leaf sparse ROW diffs (indices +
        changed rows along the leading axis), or a full per-leaf copy when
        the shape/dtype changed or the diff is dense.  The manifest records
        the base step and the sha256 of its manifest.json.  Deltas may
        chain.  Never prunes: hold chains in a ``keep=0`` manager.

        Raises ValueError when the base is missing/incomplete or the tree
        structure does not match the base's."""
        base_dir = self._step_dir(base_step, partition)
        if not os.path.exists(os.path.join(base_dir, "_COMPLETE")):
            raise ValueError(
                f"save_delta(step={step}): base checkpoint step "
                f"{base_step} is missing or incomplete under {self.root} — "
                "a delta needs its base committed first")
        with open(os.path.join(base_dir, "manifest.json")) as f:
            base_manifest = json.load(f)
        leaves, treedef = tree_flatten(tree)
        if len(leaves) != base_manifest["n_leaves"] \
                or str(treedef) != base_manifest["treedef"]:
            raise ValueError(
                f"save_delta(step={step}): tree structure does not match "
                f"base step {base_step} ({len(leaves)} leaves vs "
                f"{base_manifest['n_leaves']}) — delta checkpoints diff "
                "like against like")

        final = self._step_dir(step, partition)
        tmp = self._fresh_tmp(final)
        manifest = {
            "step": step,
            "time": time.time(),
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "extra": extra or {},
            "delta": {
                "base_step": base_step,
                "base_digest": self._manifest_digest(base_step, partition),
            },
            "leaves": [],
        }
        base_arrs, _ = self._resolve_leaves(base_step, partition)
        for i, leaf in enumerate(leaves):
            arr = _leaf_to_numpy(leaf, i)
            base_arr = base_arrs[i]
            meta = {"shape": list(arr.shape), "dtype": _dtype_name(arr)}
            rows = None
            if arr.shape == base_arr.shape and arr.dtype == base_arr.dtype \
                    and arr.ndim >= 1:
                # NaN-conservative: a NaN row compares unequal and is saved
                changed = (arr != base_arr).reshape(arr.shape[0], -1).any(1)
                idx = np.flatnonzero(changed)
                rows = arr[idx]
                if idx.nbytes + rows.nbytes >= arr.nbytes:
                    rows = None           # dense diff: full copy is smaller
            if rows is None:
                _save_leaf(os.path.join(tmp, f"arr_{i:06d}.npy"), arr)
                meta["delta"] = "full"
            else:
                np.save(os.path.join(tmp, f"idx_{i:06d}.npy"), idx)
                _save_leaf(os.path.join(tmp, f"rows_{i:06d}.npy"), rows)
                meta["delta"] = "rows"
                meta["n_rows"] = int(idx.size)
            manifest["leaves"].append(meta)
        self._commit(tmp, final, manifest)
        return final

    def _resolve_leaves(self, step: int, partition: Optional[int] = None):
        """-> (host numpy leaf list, manifest), resolving delta chains."""
        d = self._step_dir(step, partition)
        if not os.path.exists(os.path.join(d, "_COMPLETE")):
            raise ValueError(
                f"checkpoint step {step} is missing or incomplete under "
                f"{self.root}" + ("" if partition is None
                                  else f" (partition {partition})"))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        n = manifest["n_leaves"]
        if "delta" not in manifest:
            return [np.load(os.path.join(d, f"arr_{i:06d}.npy"))
                    for i in range(n)], manifest

        info = manifest["delta"]
        base_step = info["base_step"]
        base_dir = self._step_dir(base_step, partition)
        if not os.path.exists(os.path.join(base_dir, "_COMPLETE")):
            raise ValueError(
                f"delta checkpoint step {step} needs base step "
                f"{base_step}, but {base_dir} is missing or incomplete "
                "— the delta chain must be retained (build the "
                "manager with keep=0 for timeseries lineage)")
        digest = self._manifest_digest(base_step, partition)
        if digest != info["base_digest"]:
            raise ValueError(
                f"delta checkpoint step {step} was diffed against a "
                f"DIFFERENT base: step {base_step}'s manifest digest "
                f"{digest[:12]}... != recorded "
                f"{info['base_digest'][:12]}... — the base was "
                "overwritten or replaced; refusing to apply the delta")
        arrs, _ = self._resolve_leaves(base_step, partition)
        for i, meta in enumerate(manifest["leaves"]):
            if meta["delta"] == "full":
                arrs[i] = np.load(os.path.join(d, f"arr_{i:06d}.npy"))
            else:
                arr = np.array(arrs[i])          # writable copy of the base
                idx = np.load(os.path.join(d, f"idx_{i:06d}.npy"))
                if idx.size:
                    arr[idx] = np.load(os.path.join(d, f"rows_{i:06d}.npy"))
                arrs[i] = arr
        return arrs, manifest

    def _load_leaves(self, step: int, like: Any,
                     partition: Optional[int] = None):
        """``_resolve_leaves`` + structure/shape checks against ``like``."""
        arrs, manifest = self._resolve_leaves(step, partition)
        treedef = self._check_like(like, manifest, [a.shape for a in arrs])
        return arrs, treedef, manifest

    def restore_delta(self, step: int, like: Any, *,
                      partition: Optional[int] = None, device="cuda"):
        """Restore the checkpoint at ``step``, applying its delta chain ->
        (tree, extra), bit-identical to the tree ``save_delta`` was given.
        ValueError when any base in the chain is missing, incomplete or
        replaced."""
        arrs, treedef, manifest = self._load_leaves(step, like, partition)
        return _to_device(treedef, arrs, manifest, device), manifest["extra"]


# ---------------------------------------------------------------------------
# Quantized cold-attribute checkpointing (int8 per-tensor scale)
# ---------------------------------------------------------------------------

#: merged-model fields cold enough for int8 storage: degree-0 SH color and
#: the opacity logit.  Geometry (means/scales/quats) stays f32.
COLD_QUANT_FIELDS = ("colors", "opacity_logit")


def quantize_cold(tree, fields=COLD_QUANT_FIELDS):
    """-> (tree with ``fields`` as int8, JSON-able meta for ``extra``).

    Symmetric int8 per-tensor scale (scale = max|x| / 127), computed on the
    host in numpy exactly as the reference does, so the int8 arrays and the
    scales are bit-identical to its.  Pass the meta as
    ``extra={"quant": meta}`` on save so ``dequantize_cold`` (and
    ``GSRenderServer.from_checkpoint``) can restore.  A tensor field stays
    on its device, as int8."""
    meta = {"mode": "int8", "fields": {}}
    repl = {}
    for name in fields:
        leaf = getattr(tree, name)
        x = np.asarray(as_numpy(leaf), np.float32)
        scale = float(max(np.abs(x).max(), 1e-12) / 127.0)
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        repl[name] = torch.from_numpy(q).to(leaf.device) \
            if isinstance(leaf, torch.Tensor) else q
        meta["fields"][name] = scale
    return tree._replace(**repl), meta


def dequantize_cold(tree, meta: dict):
    """Invert ``quantize_cold`` with the scales recorded in ``meta``
    (``extra["quant"]``): each field becomes float32 ``q * float32(scale)``.
    A tree saved WITHOUT quantization passes through when ``meta`` is
    falsy."""
    if not meta:
        return tree
    if meta.get("mode") != "int8":
        raise ValueError(f"unknown checkpoint quant mode: {meta.get('mode')!r}")
    repl = {}
    for name, scale in meta["fields"].items():
        q = torch.as_tensor(getattr(tree, name))
        repl[name] = q.to(torch.float32) * torch.tensor(
            scale, dtype=torch.float32, device=q.device)
    return tree._replace(**repl)
