"""The serving engine's ``predict`` graphs on the card (``cuda`` marker:
each test skips without a CUDA card).

- An int8 ``ResNetCifar(8)`` engine: ``precompile`` captures one graph a
  rung and traffic captures none after it; a ``commit_staged`` of another
  weight set writes into the tensors the graphs read -- K6's packed weight
  in its own buffer -- so a replayed ``predict_at`` is bitwise the
  candidate twin's eager eval; committing the ``capture_staged`` handle
  restores the first outputs bitwise.
- A bf16 engine (``compute_dtype``) on the fp32 ``ResNetCifar(8)``: after
  a commit the replay is bitwise the candidate's own graph of that shape
  (``eval_staged``) and within 2e-2 of the largest logit of its compute
  copy evaluated eagerly (the compute copy re-cast in place; a capture may
  pick another cuBLAS algorithm for the head than an eager call).
- The step's lock: ``predict_at`` on caller threads while the dispatcher
  replays ticks of the same shapes; every output is its own request's.

No JAX here, so the file runs on the card with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_serving_graphs_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.optim.train_step import compute_copy, make_eval_step
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils.device import require_fp32_matmul


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_fp32_matmul()
    return torch.device("cuda")


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _eager(model, x, bucket, dtype=None):
    """``model``'s eager eval of ``x`` alone, padded to ``bucket`` rows."""
    batch = np.zeros((bucket,) + x.shape, np.float32)
    batch[0] = x
    step = make_eval_step(model, dtype)
    out = step(torch.from_numpy(batch).cuda())[0].cpu().numpy()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_int8_commit_in_place_and_rollback_replay_bitwise(cuda):
    live = tmodels.ResNetCifar(8, device=cuda, seed=0).eval()
    cand = tmodels.ResNetCifar(8, device=cuda, seed=1).eval()
    xs = _images(8)
    with ServingEngine(live, max_batch_size=4, quantize=True) as eng:
        built = eng.precompile(example_feature=xs[0])
        assert built == len(eng.ladder) == eng._executables()
        served = eng.predict_many(list(xs[:6]), timeout=120)
        assert eng._executables() == built
        assert all(y.shape == (10,) for y in served)
        y0 = eng.predict_at(xs[0], 4)
        packed = {id(m): m.__dict__["_k6_packed"].packed
                  for m in eng._qmodel.modules()
                  if m.__dict__.get("_k6_packed") is not None
                  and m.__dict__["_k6_packed"].packed is not None}
        assert packed
        ptrs = {k: p.data_ptr() for k, p in packed.items()}
        back = eng.capture_staged()
        h = eng.stage_weights(cand.parameters_tree(), cand.state_tree())
        assert h["staged"].step.executables() == built
        twin = tq.quantize_model(cand)[0]
        want = _eager(twin, xs[0], 4)
        np.testing.assert_array_equal(
            eng.eval_staged(h, np.concatenate(
                [xs[:1], np.zeros((3, 32, 32, 3), np.float32)]))[0], want)
        eng.commit_staged(h)
        got = eng.predict_at(xs[0], 4)
        np.testing.assert_array_equal(got, want)
        for m in eng._qmodel.modules():
            cache = m.__dict__.get("_k6_packed")
            if id(m) in packed:
                assert cache.packed is packed[id(m)]
                assert cache.packed.data_ptr() == ptrs[id(m)]
        eng.commit_staged(back)
        np.testing.assert_array_equal(eng.predict_at(xs[0], 4), y0)
        assert eng._executables() == built


@pytest.mark.cuda
def test_bf16_commit_recasts_the_compute_copy_in_place(cuda):
    live = tmodels.ResNetCifar(8, device=cuda, seed=2).eval()
    cand = tmodels.ResNetCifar(8, device=cuda, seed=3).eval()
    xs = _images(2, seed=1)
    with ServingEngine(live, max_batch_size=2,
                       compute_dtype=torch.bfloat16) as eng:
        eng.precompile(example_feature=xs[0])
        y0 = eng.predict_at(xs[0], 2)
        back = eng.capture_staged()
        h = eng.stage_weights(cand.parameters_tree(), cand.state_tree())
        batch = np.concatenate([xs[:1], np.zeros((1, 32, 32, 3),
                                                 np.float32)])
        staged = eng.eval_staged(h, batch)[0]
        eng.commit_staged(h)
        got = eng.predict_at(xs[0], 2)
        np.testing.assert_array_equal(got, staged)
        assert not np.array_equal(got, y0)
        eager = _eager(compute_copy(cand, torch.bfloat16), xs[0], 2,
                       torch.bfloat16)
        assert np.abs(got - eager).max() <= 2e-2 * np.abs(eager).max()
        eng.commit_staged(back)
        np.testing.assert_array_equal(eng.predict_at(xs[0], 2), y0)


@pytest.mark.cuda
def test_predict_at_beside_ticks_holds_the_step_lock(cuda):
    model = tmodels.ResNetCifar(8, device=cuda, seed=4).eval()
    xs = _images(32, seed=2)
    with ServingEngine(model, max_batch_size=1, max_wait_ms=0.1) as eng:
        eng.precompile(example_feature=xs[0])
        want = [eng.predict_at(x, 1) for x in xs]
        errors = []

        def caller(k):
            for i in range(k, len(xs), 4):
                if not np.array_equal(eng.predict_at(xs[i], 1), want[i]):
                    errors.append(("predict_at", i))

        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        futs = [eng.submit(x) for x in xs]
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for i, f in enumerate(futs):
            if not np.array_equal(f.result(120), want[i]):
                errors.append(("tick", i))
        assert not errors, errors
        assert eng._executables() == 1
