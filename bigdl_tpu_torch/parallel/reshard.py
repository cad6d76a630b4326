"""The layout half of portable resharding (counterpart of
``bigdl_tpu/parallel/reshard.py``: ``LayoutSpec`` :78,
``detect_block_layout`` :236, ``read_snapshot_layout`` :248,
``detect_num_experts`` :326).

``LayoutSpec`` describes how a saved tree is laid out -- strategy kind,
mesh axes and degrees, per-plane partition spec, transformer block
keying -- and is stamped into every snapshot manifest's ``layout``
block, byte for byte JAX's, so either package reads the other's.  The
trees themselves are always the logical ones (JAX's keys and shapes).

Not ported yet (ROADMAP A7, the pipeline half): ``redistribute``,
``convert_shapes`` and ``to_model_layout``.  Until then a resume whose
snapshot layout differs from the run's is refused, naming A7.
"""

import dataclasses
import re
from typing import Any, Dict, Optional

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
