"""Portable resharding (counterpart of ``bigdl_tpu/parallel/reshard.py``:
``LayoutSpec`` :78, ``detect_block_layout`` :236, ``read_snapshot_layout``
:248, ``pp_tree_to_blocks`` :272, ``blocks_to_pp_tree`` :292,
``detect_num_experts`` :326, ``_reexpert`` :353, ``_reblock`` :453,
``_restage`` :471, ``_convert_dp`` :492, ``_convert`` :534,
``convert_shapes`` :555, ``flat_to_tree`` :566, ``tree_to_flat`` :590,
``redistribute`` :637, ``to_model_layout`` :679).

``LayoutSpec`` describes how a saved tree is laid out -- strategy kind,
mesh axes and degrees, per-plane partition spec, transformer block
keying -- and is stamped into every snapshot manifest's ``layout``
block, byte for byte JAX's, so either package reads the other's.  The
tp, sp and ep trees are the logical ones (JAX's keys and shapes); a pp
tree is stage-stacked (``{embed, stages, tail}``); a dp one is a flat
plane.

``redistribute(tree, src, dst)`` maps a host tree (numpy arrays or torch
tensors; the kind of each leaf is kept) from one layout to another, as
JAX's does: dp chunk resizes, pp stage re-cuts and pp <-> per-block
trees, ep expert-count re-cuts, scan <-> unrolled block keying, and the
identity between tp, ep, sp and replicated trees.  The same structural
conversions apply to optimizer-state subtrees that mirror the
parameters (Adam's moments).  JAX records each redistribution as a
telemetry event; the port takes ``telemetry=None`` only (ROADMAP A8).
"""

import dataclasses
import logging
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

log = logging.getLogger("bigdl_tpu_torch.parallel")

#: layout kinds a LayoutSpec may carry.  "replicated" is the serving /
#: single-device layout: the model's own tree, whole on every device.
LAYOUT_KINDS = ("dp", "tp", "pp", "sp", "ep", "replicated")

#: transformer block-keying layouts (nn.attention): per-block
#: ``block{i}`` entries vs one stacked ``blocks`` entry (scan_layers)
BLOCK_LAYOUTS = ("unrolled", "scan")

_BLOCK_KEY = re.compile(r"^block(\d+)$")

#: manifest keys that are LayoutSpec structure, not per-plane detail
_SPEC_KEYS = ("kind", "mesh_axes", "block_layout")


def _jsonable(v):
    """Tuples -> lists (deep), so a spec built in python compares equal
    to the same spec round-tripped through a JSON manifest."""
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


@dataclasses.dataclass
class LayoutSpec:
    """How a saved param/opt-state tree is laid out.

    ``kind``       -- one of ``LAYOUT_KINDS``.
    ``mesh_axes``  -- axis name -> degree of the mesh the layout was
                      built for (``{"data": 2, "model": 4}``).
    ``plane``      -- kind-specific per-plane partition spec:
                      dp: ``padded_size/true_size/num_chunks/block_size/
                      ef_shape`` (the data-parallel block, verbatim);
                      tp/ep: the path-regex ``rules`` and the sharded
                      ``axis``; pp: ``n_stages/pipe_axis/
                      tensor_parallel``.
    ``block_layout`` -- transformer block keying of the tree
                      (``"unrolled"`` / ``"scan"``), or None when the
                      model family has no block keying.

    Serializes to the snapshot manifest's ``layout`` block via
    ``to_manifest`` (plane keys flattened to the top level, so the
    dp-only readers keep working) and parses back via
    ``from_manifest`` (a legacy kind-less dp block still loads).
    """

    kind: str
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    plane: Dict[str, Any] = dataclasses.field(default_factory=dict)
    block_layout: Optional[str] = None

    def __post_init__(self):
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(f"unknown layout kind {self.kind!r}; "
                             f"expected one of {LAYOUT_KINDS}")
        if self.block_layout is not None \
                and self.block_layout not in BLOCK_LAYOUTS:
            raise ValueError(
                f"unknown block_layout {self.block_layout!r}; expected "
                f"one of {BLOCK_LAYOUTS} or None")
        self.mesh_axes = {str(k): int(v) for k, v in
                          (self.mesh_axes or {}).items()}
        self.plane = _jsonable(dict(self.plane or {}))

    # ----- constructors ---------------------------------------------------- #
    @classmethod
    def dp(cls, num_chunks, padded_size, true_size, block_size=1,
           ef_shape=None, axis="data"):
        """The ZeRO-1 flat-plane layout (the data-parallel manifest block)."""
        return cls("dp", {axis: int(num_chunks)},
                   {"padded_size": int(padded_size),
                    "true_size": int(true_size),
                    "num_chunks": int(num_chunks),
                    "block_size": int(block_size),
                    "ef_shape": (None if ef_shape is None
                                 else [int(s) for s in ef_shape])})

    @classmethod
    def tp(cls, mesh_axes, axis="model", rules=None, block_layout=None):
        plane = {"axis": axis}
        if rules is not None:
            plane["rules"] = [[p, list(d)] for p, d in rules]
        return cls("tp", mesh_axes, plane, block_layout)

    @classmethod
    def ep(cls, mesh_axes, axis="expert", rules=None, num_experts=None):
        plane = {"axis": axis}
        if rules is not None:
            plane["rules"] = [[p, list(d)] for p, d in rules]
        if num_experts is not None:
            # the expert-count the tree's stacked leading dims hold --
            # what an ep -> ep expert-count re-cut converts between
            plane["num_experts"] = int(num_experts)
        return cls("ep", mesh_axes, plane)

    @classmethod
    def pp(cls, mesh_axes, n_stages, pipe_axis="pipe",
           tensor_parallel=False):
        return cls("pp", mesh_axes,
                   {"n_stages": int(n_stages), "pipe_axis": pipe_axis,
                    "tensor_parallel": bool(tensor_parallel)})

    @classmethod
    def sp(cls, mesh_axes, seq_axis="seq", block_layout=None):
        return cls("sp", mesh_axes, {"axis": seq_axis}, block_layout)

    @classmethod
    def replicated(cls, block_layout=None):
        return cls("replicated", {}, {}, block_layout)

    @classmethod
    def for_model(cls, model):
        """The ``replicated`` layout of a model's OWN tree -- what a
        serving engine or a single-device resume wants -- detecting the
        transformer block keying from its parameters' top-level keys."""
        return cls.replicated(block_layout=detect_block_layout(
            {name.split(".")[0]: None
             for name, _ in model.named_parameters()}))

    # ----- manifest round trip --------------------------------------------- #
    def to_manifest(self) -> dict:
        out = {"kind": self.kind}
        if self.mesh_axes:
            out["mesh_axes"] = dict(self.mesh_axes)
        if self.block_layout is not None:
            out["block_layout"] = self.block_layout
        out.update(self.plane)
        return out

    @classmethod
    def from_manifest(cls, block) -> Optional["LayoutSpec"]:
        """Parse a manifest ``layout`` block; None passes through.  A
        legacy data-parallel block (no ``kind`` -- only the dp saver stamped
        one) parses as dp."""
        if not block:
            return None
        d = dict(block)
        kind = d.pop("kind", "dp")
        mesh_axes = d.pop("mesh_axes", None) or {}
        block_layout = d.pop("block_layout", None)
        if kind == "dp" and not mesh_axes and "num_chunks" in d:
            mesh_axes = {"data": int(d["num_chunks"])}
        return cls(kind, mesh_axes, d, block_layout)

    @classmethod
    def coerce(cls, spec) -> "LayoutSpec":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            out = cls.from_manifest(spec)
            if out is not None:
                return out
        raise ValueError(f"cannot interpret {spec!r} as a LayoutSpec")

    # ----- accessors -------------------------------------------------------- #
    def degree(self, axis, default=1) -> int:
        return int(self.mesh_axes.get(axis, default))

    @property
    def n_stages(self):
        return int(self.plane["n_stages"]) if "n_stages" in self.plane \
            else None

    def describe(self) -> str:
        """Short human label: ``tp[data=2,model=4]``, ``dp[data=8]``."""
        axes = ",".join(f"{k}={v}" for k, v in sorted(self.mesh_axes.items()))
        extra = ""
        if self.kind == "pp" and self.n_stages is not None:
            extra = f"/stages={self.n_stages}"
        if self.block_layout == "scan":
            extra += "/scan"
        return f"{self.kind}[{axes}]{extra}" if axes \
            else f"{self.kind}{extra}"

    def __eq__(self, other):
        if not isinstance(other, LayoutSpec):
            return NotImplemented
        return (self.kind == other.kind
                and self.mesh_axes == other.mesh_axes
                and _jsonable(self.plane) == _jsonable(other.plane)
                and self.block_layout == other.block_layout)


def detect_block_layout(params) -> Optional[str]:
    """``"scan"`` / ``"unrolled"`` / None from a params tree's keying
    (the TransformerLM layouts ``stack_block_params`` interconverts)."""
    if not isinstance(params, dict):
        return None
    if "blocks" in params:
        return "scan"
    if any(_BLOCK_KEY.match(k) for k in params):
        return "unrolled"
    return None


def read_snapshot_layout(path) -> Optional[LayoutSpec]:
    """The LayoutSpec stamped into a snapshot's sidecar manifest, or
    None (legacy manifest-less snapshot, or a pre-PR-12 strategy
    snapshot that recorded no layout)."""
    from bigdl_tpu_torch.utils import file_io

    manifest = file_io.read_manifest(path) or {}
    return LayoutSpec.from_manifest(manifest.get("layout"))


# --------------------------------------------------------------------------- #
# Structural conversions (pure; host trees of numpy arrays or tensors).
# --------------------------------------------------------------------------- #


def _is_leaf_empty(t):
    return isinstance(t, (tuple, list)) and not t


def _tree_map(fn, *trees):
    """``jax.tree.map`` over nested dicts: ``()`` entries (JAX's empty
    subtrees) pass through."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if _is_leaf_empty(first):
        return first
    return fn(*trees)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif not _is_leaf_empty(tree):
        yield tree


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _is_pp_tree(t) -> bool:
    return isinstance(t, dict) and set(t) == {"embed", "stages", "tail"}


def _has_block_keys(t) -> bool:
    return isinstance(t, dict) and ("blocks" in t
                                    or any(_BLOCK_KEY.match(k) for k in t))


def pp_tree_to_blocks(pp_tree):
    """Stage-stacked pp params (``{embed, stages, tail}``,
    ``parallel/pp.stack_stage_params`` layout) -> the plain per-block
    TransformerLM tree, a pure tree transformation that also applies to
    optimizer-moment subtrees mirroring the params.  Inverse of
    ``blocks_to_pp_tree``."""
    stages = pp_tree["stages"]
    lps = len(stages)
    n_stages = int(next(_tree_leaves(stages["layer0"])).shape[0])
    out = {"wte": pp_tree["embed"]["wte"], "wpe": pp_tree["embed"]["wpe"],
           "ln_f": pp_tree["tail"]["ln_f"], "head": pp_tree["tail"]["head"]}
    for s in range(n_stages):
        for j in range(lps):
            out[f"block{s * lps + j}"] = _tree_map(
                lambda a, _s=s: a[_s], stages[f"layer{j}"])
    return out


def blocks_to_pp_tree(tree, n_stages):
    """Plain per-block TransformerLM tree -> the ``n_stages``
    stage-stacked pp layout (``parallel/pp.stack_stage_params``
    semantics, model-free).  The block count must divide evenly into
    the stages."""
    idx = sorted(int(m.group(1)) for k in tree
                 if (m := _BLOCK_KEY.match(k)))
    if not idx or idx != list(range(len(idx))):
        raise ValueError(
            f"cannot stage-stack: expected contiguous block0..blockN "
            f"entries, got {sorted(k for k in tree)[:8]}")
    n_layers = len(idx)
    n_stages = int(n_stages)
    if n_layers % n_stages:
        raise ValueError(
            f"cannot re-cut {n_layers} blocks into {n_stages} pipeline "
            f"stages: block count must divide evenly")
    lps = n_layers // n_stages
    stages = {}
    for j in range(lps):
        per_stage = [tree[f"block{s * lps + j}"] for s in range(n_stages)]
        stages[f"layer{j}"] = _tree_map(_stack, *per_stage)
    return {
        "embed": {"wte": tree["wte"], "wpe": tree["wpe"]},
        "stages": stages,
        "tail": {"ln_f": tree["ln_f"], "head": tree["head"]},
    }


def detect_num_experts(params) -> Optional[int]:
    """The expert count of the first MoE-shaped subtree in ``params``
    (``nn/moe.py`` keying: ``gate (D, E)`` beside expert-stacked
    ``w1 (E, D, F)``), or None for expert-free models -- what the ep
    layout stamp records so an expert-count re-cut knows both sides."""
    found = []

    def look(d):
        if _is_moe_node(d) and not found:
            found.append(int(d["gate"].shape[-1]))
        return None

    _walk_dicts(params, look)
    return found[0] if found else None


def _is_moe_node(d) -> bool:
    """An ``nn/moe.py``-shaped params dict (or an optimizer-moment
    subtree mirroring one): a 2-D router ``gate`` whose logits dim
    matches the leading expert-stacked dim of a 3-D ``w1``."""
    if not isinstance(d, dict) or not {"gate", "w1", "w2"} <= set(d):
        return False
    gate, w1 = d.get("gate"), d.get("w1")
    return (getattr(gate, "ndim", 0) == 2 and getattr(w1, "ndim", 0) == 3
            and gate.shape[-1] == w1.shape[0])


def _walk_dicts(tree, fn):
    """Apply ``fn`` to every dict node top-down; when ``fn`` returns a
    replacement (non-None), recursion stops for that subtree."""
    if isinstance(tree, dict):
        replaced = fn(tree)
        if replaced is not None:
            return replaced
        return {k: _walk_dicts(v, fn) for k, v in tree.items()}
    return tree


def _repeat(a, k, axis):
    if isinstance(a, torch.Tensor):
        return torch.repeat_interleave(a, k, dim=axis)
    return np.repeat(np.asarray(a), k, axis=axis)


def _concrete(a):
    """A host numpy view of a leaf, or None for a shapes-only (meta)
    tensor (``convert_shapes``), where only the shapes matter."""
    if isinstance(a, torch.Tensor):
        return None if a.is_meta else a.detach().cpu().numpy()
    return np.asarray(a)


def _reexpert(tree, src_e, dst_e):
    """ep -> ep expert-count re-cut of every MoE-shaped subtree (params
    and mirrored moments): a grow (``dst_e = k * src_e``) splits each
    expert into ``k`` consecutive identical replicas and repeats its gate
    logit column; a shrink (``src_e = k * dst_e``) is the inverse and
    requires each group of ``k`` to be identical (an undiverged grow),
    else it raises.  Grow then shrink is bit-identical."""
    src_e, dst_e = int(src_e), int(dst_e)
    if src_e == dst_e:
        return tree
    if dst_e % src_e and src_e % dst_e:
        raise ValueError(
            f"cannot re-cut {src_e} experts into {dst_e}: expert counts "
            f"must divide evenly (grow k-for-1 or merge k-to-1)")

    def grow(d, k):
        out = dict(d)
        for key, a in d.items():
            if not hasattr(a, "shape"):
                continue
            if key == "gate":
                out[key] = _repeat(a, k, -1)
            elif a.ndim >= 1 and a.shape[0] == src_e:
                out[key] = _repeat(a, k, 0)
        return out

    def shrink(d, k):
        out = dict(d)
        for key, a in d.items():
            if not hasattr(a, "shape"):
                continue
            if key == "gate":
                g = a.reshape(tuple(a.shape[:-1]) + (dst_e, k))
                gc = _concrete(g)
                if gc is not None and not (gc == gc[..., :1]).all():
                    raise ValueError(
                        f"cannot merge {src_e} experts into {dst_e}: "
                        f"gate logit columns of a replica group differ "
                        f"-- these are genuinely distinct experts, not "
                        f"an undiverged grow")
                out[key] = g[..., 0]
            elif a.ndim >= 1 and a.shape[0] == src_e:
                g = a.reshape((dst_e, k) + tuple(a.shape[1:]))
                gc = _concrete(g)
                if gc is not None and not (gc == gc[:, :1]).all():
                    raise ValueError(
                        f"cannot merge {src_e} experts into {dst_e}: "
                        f"expert plane {key!r} differs within a replica "
                        f"group -- these are genuinely distinct "
                        f"experts, not an undiverged grow")
                out[key] = g[:, 0]
        return out

    def convert(d):
        if not _is_moe_node(d) or d["gate"].shape[-1] != src_e:
            return None
        return grow(d, dst_e // src_e) if dst_e > src_e \
            else shrink(d, src_e // dst_e)

    return _walk_dicts(tree, convert)


def _reblock(tree, src_bl, dst_bl):
    """scan <-> unrolled transformer block keying of every subtree that
    carries block keys (params and mirrored moments)."""
    if src_bl == dst_bl or src_bl is None or dst_bl is None:
        return tree
    from bigdl_tpu_torch.nn.attention import (stack_block_params,
                                              unstack_block_params)

    def convert(d):
        if dst_bl == "unrolled" and "blocks" in d:
            return unstack_block_params(d)
        if dst_bl == "scan" and any(_BLOCK_KEY.match(k) for k in d):
            return stack_block_params(d)
        return None

    return _walk_dicts(tree, convert)


def _restage(tree, src, dst):
    """pp stage re-cutting and pp <-> per-block restructuring, applied
    to every subtree (optimizer-state dicts mirroring the params too)."""
    src_pp = src.kind == "pp"
    dst_pp = dst.kind == "pp"
    if not src_pp and not dst_pp:
        return tree

    def convert(d):
        if src_pp and _is_pp_tree(d):
            blocks = pp_tree_to_blocks(d)
            return blocks_to_pp_tree(blocks, dst.n_stages) if dst_pp \
                else blocks
        if not src_pp and dst_pp and _has_block_keys(d):
            return blocks_to_pp_tree(d, dst.n_stages)
        return None

    return _walk_dicts(tree, convert)


def _convert_dp(tree, src, dst):
    """dp -> dp chunk-layout resize: flat planes refit their trailing
    padding (``zero.refit_flat_plane``), the EF residual plane
    re-partitions by global offset (``zero.repartition_ef_residual``),
    everything else passes through."""
    from bigdl_tpu_torch.parallel.zero import (refit_flat_plane,
                                               repartition_ef_residual)

    if int(src.plane["true_size"]) != int(dst.plane["true_size"]):
        raise ValueError(
            f"dp layouts hold different parameter counts "
            f"({src.plane['true_size']} vs {dst.plane['true_size']}): "
            "this is a different model, not a chunk-layout change")
    src_padded = int(src.plane["padded_size"])
    dst_padded = int(dst.plane["padded_size"])
    true = int(dst.plane["true_size"])
    src_ef = src.plane.get("ef_shape")
    dst_ef = dst.plane.get("ef_shape")

    def fix(a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if src_ef and dst_ef and a.ndim == 2 \
                and tuple(a.shape) == tuple(src_ef):
            if a.shape[0] == int(dst.plane["num_chunks"]):
                # the same rank count: each row stays its rank's own
                # error, trailing padding refitted
                return refit_flat_plane(a, dst_padded, true)
            return repartition_ef_residual(
                _concrete(a), true, int(dst.plane["num_chunks"]),
                dst_padded)
        if a.ndim >= 1 and a.shape[-1] == src_padded:
            return refit_flat_plane(a, dst_padded, true)
        return a

    return _tree_map(fix, tree)


def _convert(tree, src, dst):
    if src.kind == "dp" or dst.kind == "dp":
        if src.kind == dst.kind == "dp":
            return _convert_dp(tree, src, dst)
        raise ValueError(
            f"cannot redistribute {src.kind} -> {dst.kind} directly: "
            "the dp layout is a FLAT plane; convert through the model "
            "tree with flat_to_tree/tree_to_flat (they need the "
            "model's tree as the unravel template)")
    if src.kind == "ep" and dst.kind == "ep":
        se = src.plane.get("num_experts")
        de = dst.plane.get("num_experts")
        if se is not None and de is not None and int(se) != int(de):
            tree = _reexpert(tree, se, de)
    out = _restage(tree, src, dst)
    # pp trees are unrolled by construction on both sides of _restage
    src_bl = "unrolled" if src.kind == "pp" else src.block_layout
    dst_bl = "unrolled" if dst.kind == "pp" else dst.block_layout
    return _reblock(out, src_bl, dst_bl)


def _meta(a):
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    a = np.asarray(a)
    return torch.empty(a.shape, dtype=torch.from_numpy(
        np.empty(0, a.dtype)).dtype, device="meta")


def convert_shapes(tree, src, dst):
    """``redistribute`` on shapes only (JAX: ``jax.eval_shape``): the
    tree's leaves as meta tensors (shape and dtype, no data) converted
    from ``src`` to ``dst``.  dp layouts are excluded, as in JAX (the
    residual re-partition needs the values)."""
    return _convert(_tree_map(_meta, tree), LayoutSpec.coerce(src),
                    LayoutSpec.coerce(dst))


def _named_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named_leaves(v, f"{prefix}{k}."))
        elif not _is_leaf_empty(v):
            out[f"{prefix}{k}"] = v
    return out


def _nested(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, key = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[key] = leaf
    return tree


def flat_to_tree(flat, layout, tree_template):
    """dp flat plane -> the model's own parameter tree (nested dicts, in
    the flat plane's kind: numpy views or tensor views).
    ``tree_template`` (the model's tree, any leaves with ``.shape``)
    gives the unravel bijection; ``layout`` guards that the plane holds
    this model."""
    from bigdl_tpu_torch.parallel.zero import FlatParamSpace

    layout = LayoutSpec.coerce(layout)
    space = FlatParamSpace(_named_leaves(tree_template), 1)
    true = int(layout.plane.get("true_size", space.true_size))
    if true != space.true_size:
        raise ValueError(
            f"dp flat plane holds {true} parameters but the target "
            f"model tree holds {space.true_size}: different model")
    if not isinstance(flat, torch.Tensor):
        flat = np.asarray(flat)
    if flat.shape[-1] < space.true_size:
        raise ValueError(
            f"flat plane of {flat.shape[-1]} elements cannot fill a "
            f"{space.true_size}-parameter tree")
    return _nested(space.unflatten(flat))


def tree_to_flat(tree, layout):
    """Model parameter tree -> a dp flat plane (an fp32 tensor) under
    ``layout``'s chunk rounding: the inverse of ``flat_to_tree``."""
    from bigdl_tpu_torch.parallel.zero import FlatParamSpace

    layout = LayoutSpec.coerce(layout)
    named = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in _named_leaves(tree).items()}
    space = FlatParamSpace(named, int(layout.plane["num_chunks"]),
                           int(layout.plane.get("block_size", 1)))
    if space.padded_size != int(layout.plane["padded_size"]):
        raise ValueError(
            f"tree flattens to padded size {space.padded_size}, layout "
            f"says {layout.plane['padded_size']}: different model or "
            "block rounding")
    return space.flatten(named)


def _tree_stats(tree):
    leaves = [l for l in _tree_leaves(tree) if hasattr(l, "nbytes")]
    return len(leaves), int(sum(int(l.nbytes) for l in leaves))


def _refuse_telemetry(telemetry):
    if telemetry is not None:
        raise UnsupportedFeatureError(
            "redistribute(telemetry=...): the reshard audit event is "
            "observability, not ported yet (ROADMAP A8)")


def redistribute(tree, src, dst, telemetry=None, what="params"):
    """Map a host tree saved under layout ``src`` onto layout ``dst``
    (either a ``LayoutSpec`` or a manifest dict).  Covered, as in JAX:
    dp -> dp chunk resizes; pp -> pp stage re-cuts; pp <->
    tp/ep/sp/replicated (stage-stacked <-> per-block trees); ep -> ep
    expert-count re-cuts (``num_experts`` in both planes); scan <->
    unrolled block keying; tp/ep/sp <-> replicated (the identity on the
    values).  Identical layouts return the tree itself.  ``telemetry``:
    None only (ROADMAP A8)."""
    _refuse_telemetry(telemetry)
    src = LayoutSpec.coerce(src)
    dst = LayoutSpec.coerce(dst)
    if src == dst:
        return tree
    t0 = time.perf_counter()
    out = _convert(tree, src, dst)
    planes, host_bytes = _tree_stats(out)
    log.info("resharded %s: %s -> %s (%d planes, %d host bytes, %.3fs)",
             what, src.describe(), dst.describe(), planes, host_bytes,
             time.perf_counter() - t0)
    return out


def to_model_layout(params, src_layout, model, telemetry=None,
                    what="params"):
    """Any snapshot's params -> the ``model``'s own (replicated) tree
    layout: dp flat planes unravel through the model's tree, strategy,
    pp and scan trees restructure through ``redistribute``."""
    _refuse_telemetry(telemetry)
    src = LayoutSpec.coerce(src_layout)
    if src.kind == "dp":
        return flat_to_tree(params, src, model.parameters_tree())
    return redistribute(params, src, LayoutSpec.for_model(model),
                        what=what)
