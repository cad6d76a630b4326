"""The layout half of the port's resharding (``bigdl_tpu_torch/parallel/
reshard.py``) against the JAX package's ``parallel/reshard.py``, the
``LayoutSpec`` each strategy stamps into its checkpoints, the named mesh
(``parallel/mesh.py``, ``Engine.build_mesh``) and the import rule for the
model-parallel modules, on the CPU.  Pure structure: equal dicts and
strings, no tolerance.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.optim.strategy_optimizer import \
    StrategyOptimizer as JaxStrategyOptimizer
from bigdl_tpu.parallel import reshard as jr
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.nn.moe import MoETransformerLM
from bigdl_tpu_torch.parallel import reshard as tr
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.engine import Engine

ROOT = Path(__file__).resolve().parents[1]

NEW_MODULES = ["bigdl_tpu_torch.parallel.mesh", "bigdl_tpu_torch.parallel.tp",
               "bigdl_tpu_torch.parallel.ep",
               "bigdl_tpu_torch.parallel.sequence",
               "bigdl_tpu_torch.parallel.ring_attention",
               "bigdl_tpu_torch.parallel.ulysses",
               "bigdl_tpu_torch.parallel.reshard",
               "bigdl_tpu_torch.parallel.strategy_step",
               "bigdl_tpu_torch.nn.moe",
               "bigdl_tpu_torch.optim.strategy_optimizer"]

SPECS = [
    ("dp", lambda m: m.dp(4, 1024, 1000, block_size=2, ef_shape=[4, 1024])),
    ("tp", lambda m: m.tp({"data": 2, "model": 4},
                          rules=[(r"qkv", ("model", None))],
                          block_layout="unrolled")),
    ("ep", lambda m: m.ep({"data": 2, "expert": 2}, num_experts=8)),
    ("pp", lambda m: m.pp({"data": 2, "pipe": 4}, 4, tensor_parallel=True)),
    ("sp", lambda m: m.sp({"data": 1, "seq": 8}, block_layout="scan")),
    ("replicated", lambda m: m.replicated("unrolled")),
]


@pytest.fixture
def world_of_one():
    yield
    Engine.reset()


@pytest.mark.parametrize("kind,make", SPECS, ids=[k for k, _ in SPECS])
def test_layout_spec_matches_jax(kind, make):
    got, want = make(tr.LayoutSpec), make(jr.LayoutSpec)
    assert got.to_manifest() == want.to_manifest()
    assert json.dumps(got.to_manifest()) == json.dumps(want.to_manifest())
    assert got.describe() == want.describe()
    assert got.n_stages == want.n_stages
    assert got.degree("data") == want.degree("data")
    back = tr.LayoutSpec.from_manifest(
        json.loads(json.dumps(want.to_manifest())))
    assert back == got and tr.LayoutSpec.coerce(got.to_manifest()) == got
    assert back != tr.LayoutSpec.replicated("scan")


def test_legacy_blocks_and_refusals_match_jax():
    legacy = {"padded_size": 8, "true_size": 7, "num_chunks": 2,
              "block_size": 1, "ef_shape": None}
    assert tr.LayoutSpec.from_manifest(legacy).to_manifest() == \
        jr.LayoutSpec.from_manifest(legacy).to_manifest()
    assert tr.LayoutSpec.from_manifest(None) is None
    for pkg in (tr, jr):
        with pytest.raises(ValueError, match="unknown layout kind"):
            pkg.LayoutSpec("zz")
        with pytest.raises(ValueError, match="cannot interpret"):
            pkg.LayoutSpec.coerce(3)


def test_tree_detectors_match_jax():
    x = jax.ShapeDtypeStruct((2, 8), jnp.int32)
    for scan in (False, True):
        jm = JaxLM(64, 32, 4, 2, max_len=16, scan_layers=scan)
        jm.build(x)
        params = jm.parameters()[0]
        assert tr.detect_block_layout(params) == \
            jr.detect_block_layout(params)
        tm = nn.TransformerLM(64, 32, 4, 2, max_len=16, device="cpu",
                              scan_layers=scan)
        assert tr.LayoutSpec.for_model(tm) == tr.LayoutSpec.from_manifest(
            jr.LayoutSpec.for_model(jm).to_manifest())
    moe = MoETransformerLM(64, 32, 4, 2, 8, max_len=16, device="cpu")
    assert tr.detect_num_experts(moe.parameters_tree()) == 8
    assert tr.detect_num_experts({"w": np.zeros(3)}) is None
    assert tr.detect_block_layout([]) is None


def test_read_snapshot_layout(tmp_path):
    spec = tr.LayoutSpec.tp({"data": 1, "model": 2})
    path = file_io.save_checkpoint(str(tmp_path), 3, {"w": np.zeros(2)}, (),
                                   {}, {"neval": 3},
                                   manifest_meta={"layout":
                                                  spec.to_manifest()})
    assert tr.read_snapshot_layout(path) == spec
    assert jr.read_snapshot_layout(path).to_manifest() == spec.to_manifest()
    assert tr.read_snapshot_layout(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("strategy,axes", [
    ("tp", ("data", "model")), ("sp", ("data", "seq")),
    ("ep", ("data", "expert"))])
def test_strategy_layout_spec_is_jax(strategy, axes, world_of_one):
    """The ``layout`` block each strategy stamps, against JAX's
    ``_layout_spec`` of the same model tree and mesh shape."""
    from bigdl_tpu.nn.moe import MoETransformerLM as JaxMoE

    x = jax.ShapeDtypeStruct((2, 8), jnp.int32)
    if strategy == "ep":
        jm = JaxMoE(64, 32, 4, 2, 4, max_len=16)
        tm = MoETransformerLM(64, 32, 4, 2, 4, max_len=16, device="cpu")
    else:
        seq = "seq" if strategy == "sp" else None
        jm = JaxLM(64, 32, 4, 2, max_len=16, seq_axis_name=seq)
        tm = nn.TransformerLM(64, 32, 4, 2, max_len=16, device="cpu",
                              seq_axis_name=seq)
    jm.build(x)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                              axes)
    jopt = JaxStrategyOptimizer(jm, None, None, strategy=strategy,
                                mesh=jmesh)
    ds = array_dataset(np.zeros((2, 8), np.int32),
                       np.zeros((2, 8), np.int32)) >> SampleToMiniBatch(2)
    topt = optim.Optimizer(tm, ds, None, strategy=strategy,
                           mesh=Engine.build_mesh((1, 1), axes,
                                                  device="cpu"),
                           device="cpu")
    assert topt._layout_spec().to_manifest() == \
        jopt._layout_spec(jm.parameters()[0]).to_manifest()


def test_mesh_lays_ranks_out_row_major(world_of_one):
    mesh = Engine.build_mesh((1, 1, 1), ("data", "model", "seq"),
                             device="cpu")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1}
    assert mesh.coords == {"data": 0, "model": 0, "seq": 0}
    assert mesh.collectives("seq", "data").world == 1
    with pytest.raises(ValueError, match="holds 2 devices"):
        Engine.build_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not an axis"):
        mesh.collectives("expert")
    from bigdl_tpu_torch.parallel.mesh import axis_collectives
    with pytest.raises(NameError, match="unbound axis name"):
        axis_collectives("seq")
    with mesh.bound():
        assert axis_collectives("seq").world == 1


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'bigdl_tpu' or "
              "m.startswith('bigdl_tpu.'))\n"
              "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
