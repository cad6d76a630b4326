"""TensorBoard summaries of the port (``bigdl_tpu_torch/visualization``,
the optimizer's step events and ``Parameters`` histograms, the recipes'
``--summaryDir``) against the JAX package's ``bigdl_tpu/visualization``,
on the CPU; the summary cases of JAX's ``tests/test_vis_predict.py``.

- crc32c test vectors; scalar and histogram records byte for byte JAX's
  at a fixed wall time; each package reads the other's event files.
- ``TrainSummary`` / ``ValidationSummary`` directories, the summary
  trigger, ``add_step_event`` (``DataWaitSeconds``), ``add_health_event``.
- ``optimize()`` writes ``Loss``, ``Throughput``, ``DataWaitSeconds`` and
  ``LearningRate`` each step (LeNet-5, JAX's weights: losses within 1e-5
  of JAX's run and the rate exact), and ``Parameters`` histograms where
  the trigger fires, tagged by JAX's ``keystr`` paths.
- Every recipe takes ``--summaryDir`` (with ``--appName``).
"""

import os
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.dataset import array_dataset as jarray
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models import run as trun
from bigdl_tpu_torch.visualization import (TrainSummary, ValidationSummary,
                                           read_scalar)
from bigdl_tpu_torch.visualization import tensorboard as ttb


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_crc32c_known_vectors_and_masking_match_jax():
    assert ttb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ttb.crc32c(b"123456789") == 0xE3069283
    for data in (b"", b"abc", bytes(range(256))):
        assert ttb._masked_crc(data) == jtb._masked_crc(data)


@pytest.mark.parametrize("value,step", [(1.5, 1), (-3.25e-7, 2 ** 40),
                                        (float("inf"), 0)])
def test_scalar_records_are_jax_bytes(value, step):
    assert ttb.encode_scalar_event("Loss", value, step, 1234.5) == \
        jtb.encode_scalar_event("Loss", value, step, 1234.5)


def test_histogram_records_are_jax_bytes():
    v = np.random.default_rng(0).standard_normal(100)
    assert ttb.encode_histogram_event("w", v, 3, 99.0) == \
        jtb.encode_histogram_event("w", v, 3, 99.0)


def _frames(path):
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        out.append(data[off + 12:off + 12 + n])
        off += 12 + n + 4
    return out


def test_each_package_reads_the_others_event_files(tmp_path):
    t = TrainSummary(str(tmp_path / "t"), "app")
    j = JTrainSummary(str(tmp_path / "j"), "app")
    for s in (t, j):
        s.add_scalar("Loss", 1.5, 1).add_scalar("Loss", 0.5, 2)
        s.add_scalar("Throughput", 100.0, 1)
        s.add_histogram("weights", np.arange(10.0), 1)
        s.close()
    assert os.path.basename(t.writer.path).endswith(".bigdl_tpu_torch")
    for log_dir in (t.log_dir, j.log_dir):
        want = [(1, 1.5), (2, 0.5)]
        assert [(s, v) for s, v, _ in read_scalar(log_dir, "Loss")] == want
        assert [(s, v) for s, v, _ in jtb.read_scalar(log_dir, "Loss")] == \
            want
        assert len(read_scalar(log_dir, "Throughput")) == 1
    # the same records: a version header, then events differing only in
    # their wall times
    tf, jf = _frames(t.writer.path), _frames(j.writer.path)
    assert len(tf) == len(jf) == 5
    assert tf[0][9:] == jf[0][9:] == b"\x1a\x0dbrain.Event:2"
    for a, b in zip(tf[1:], jf[1:]):
        assert a[9:] == b[9:]


def test_summary_directories_and_triggers(tmp_path):
    t = TrainSummary(str(tmp_path), "app")
    v = ValidationSummary(str(tmp_path), "app")
    assert t.log_dir == os.path.join(str(tmp_path), "app", "train")
    assert v.log_dir == os.path.join(str(tmp_path), "app", "validation")
    trig = optim.Trigger.several_iteration(2)
    assert t.set_summary_trigger("Parameters", trig) is t
    assert t.get_summary_trigger("Parameters") is trig
    assert t.get_summary_trigger("Gradients") is None


def test_step_and_health_events(tmp_path):
    t = TrainSummary(str(tmp_path), "app")
    t.add_step_event({"step": 3, "loss": 0.25, "records_per_s": 64.0,
                      "data_wait_s": 0.125})
    t.add_step_event({"step": 4, "loss": 0.5, "records_per_s": 32.0})
    t.add_health_event({"step": 4, "grad_norm": 2.0, "update_ratio_max": 0.5,
                        "nonfinite_grads": 0, "nonfinite_params": 0,
                        "layers": {"['0']": {"grad_norm": 1.0,
                                             "update_ratio": 0.25}}})
    t.close()

    def read(tag):
        return [(s, v) for s, v, _ in t.read_scalar(tag)]

    assert read("Loss") == [(3, 0.25), (4, 0.5)]
    assert read("Throughput") == [(3, 64.0), (4, 32.0)]
    assert read("DataWaitSeconds") == [(3, 0.125)]
    assert read("Health/GradNorm") == [(4, 2.0)]
    assert read("Health/UpdateRatio['0']") == [(4, 0.25)]


def _lenet_runs(tmp_path, steps=3):
    x = np.random.default_rng(0).random((64, 28, 28), dtype=np.float32)
    y = np.random.default_rng(1).integers(0, 10, 64).astype(np.int32)
    jm = jlenet.LeNet5()
    jm.build(jax.ShapeDtypeStruct((2, 28, 28), jnp.float32),
             rng=jax.random.PRNGKey(0))
    tm = load_jax_params(tmodels.LeNet5(device="cpu"),
                         jax.tree.map(np.asarray, jm.parameters()[0]))
    ts = TrainSummary(str(tmp_path / "t"), "lenet")
    ts.set_summary_trigger("Parameters", optim.Trigger.several_iteration(2))
    opt = optim.Optimizer(tm, array_dataset(x, y) >> SampleToMiniBatch(32),
                          nn.ClassNLLCriterion(),
                          optim.SGD(learning_rate=0.1), device="cpu")
    opt.set_train_summary(ts).set_end_when(
        optim.Trigger.max_iteration(steps))
    opt.optimize()
    js = JTrainSummary(str(tmp_path / "j"), "lenet")
    js.set_summary_trigger("Parameters", joptim.Trigger.several_iteration(2))
    jopt = joptim.LocalOptimizer(jm, jarray(x, y) >> JToBatch(32),
                                 jnn.ClassNLLCriterion(),
                                 joptim.SGD(learning_rate=0.1))
    jopt.set_train_summary(js).set_end_when(
        joptim.Trigger.max_iteration(steps))
    jopt.optimize()
    return ts, js


def _tags(log_dir):
    """Every (tag, step) of an event file, scalars and histograms."""
    tags = []
    for fname in os.listdir(log_dir):
        for frame in _frames(os.path.join(log_dir, fname))[1:]:
            fields = dict((f, v) for f, _, v in jtb._parse_fields(frame))
            value = dict((f, v) for f, _, v in jtb._parse_fields(
                dict((f, v) for f, _, v in jtb._parse_fields(
                    fields[5]))[1]))
            tags.append((value[1].decode(), fields[2]))
    return tags


def test_optimize_writes_jax_summaries(tmp_path):
    ts, js = _lenet_runs(tmp_path)
    losses = ts.read_scalar("Loss")
    assert [s for s, _, _ in losses] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v, _ in losses],
                               [v for _, v, _ in js.read_scalar("Loss")],
                               rtol=1e-5)
    for tag in ("Throughput", "DataWaitSeconds"):
        assert [s for s, _, _ in ts.read_scalar(tag)] == [1, 2, 3]
    assert [v for _, v, _ in ts.read_scalar("LearningRate")] == \
        [v for _, v, _ in js.read_scalar("LearningRate")]
    assert abs(ts.read_scalar("LearningRate")[0][1] - 0.1) < 1e-6
    # the Parameters histograms fire at neval 2 only, under JAX's tags
    hist = sorted(t for t in _tags(ts.log_dir) if t[0].startswith("Param"))
    jhist = sorted(t for t in _tags(js.log_dir) if t[0].startswith("Param"))
    assert hist == jhist and {s for _, s in hist} == {2}
    assert ("Parameters['1']['weight']", 2) in hist


@pytest.mark.parametrize("recipe", [
    ["lenet-train", "--synthN", "64", "-b", "16"],
    ["vgg-train", "--synthN", "24", "-b", "6"],
    ["transformer-train", "--synthN", "16", "-b", "4", "--vocab", "64",
     "--seq-len", "16"]])
def test_recipes_take_summary_dir(recipe, tmp_path):
    """``--summaryDir D --appName A`` sets a ``TrainSummary`` under
    ``D/A/train`` (JAX ``_build_optimizer`` :79-81): one ``Loss``,
    ``Throughput`` and ``LearningRate`` point a step."""
    opt = trun.main(recipe + ["--maxIteration", "2", "--device", "cpu",
                              "--summaryDir", str(tmp_path),
                              "--appName", "app"])
    log_dir = os.path.join(str(tmp_path), "app", "train")
    assert isinstance(opt.train_summary, TrainSummary)
    assert opt.train_summary.log_dir == log_dir
    for tag in ("Loss", "Throughput", "LearningRate"):
        assert [s for s, _, _ in read_scalar(log_dir, tag)] == [1, 2], tag


def test_every_recipe_parses_the_summary_and_prefetch_flags(monkeypatch):
    """The flags the recipes refused until the summaries and prefetch
    workers were ported, on every subcommand's parser."""
    seen = []

    def fn(args):
        seen.append((args.command, args.summary_dir, args.app_name,
                     args.num_workers, args.queue_depth))

    monkeypatch.setattr(trun, "cmd_transformer_train", fn)
    for name, entry in list(trun.CNN_RECIPES.items()):
        monkeypatch.setitem(trun.CNN_RECIPES, name, (fn,) + entry[1:])
    names = list(trun.CNN_RECIPES) + ["transformer-train"]
    for name in names:
        trun.main([name, "--summaryDir", "d", "--appName", "a",
                   "--numWorkers", "3", "--queueDepth", "5"])
    assert seen == [(name, "d", "a", 3, 5) for name in names]
