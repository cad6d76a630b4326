#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bigdl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, TF32 switched off;
2. build: the CUDA kernels compiled from ``bigdl_tpu_torch/csrc``;
3. kernels: K1 ``flash_attention``, K2 ``flash_decode_attention`` and K3
   ``flash_paged_decode_attention`` held against their plain PyTorch
   versions at the serving path's shapes (fp32, H 12, D 64), with kernel,
   plain and library device times (CUDA-graph replays, so no host work
   sits between launches) and the least time the card could take;
4. end to end: TransformerLM "small" (random weights from a seed) served
   by three engines -- paged (kernels), contiguous (kernels) and paged
   with the plain attention -- on the same greedy prompts, plus sampled
   requests and ``predict``; every kernel's launch count must rise on
   this main path, the greedy streams must agree and ``predict`` must
   match the plain model;
5. served steps: one more greedy burst through the two kernel engines in
   which every step the model serves is also run by the plain model on a
   copy of the cache taken before it, logits held to 1e-4.  With random
   weights the greedy streams repeat a few tokens, so equal streams
   alone show little; these logits carry the evidence.

Then one ``{"kernels": [...]}`` line and, last, the device line.  Any
failure raises and exits non-zero; without a CUDA card the script exits
non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: published H100 SXM rates (NVIDIA data sheet): HBM bytes/s and the
#: fp32 CUDA-core FLOP/s (these fp32 kernels do not use tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
ATOL = RTOL = 1e-4

HEADS, HEAD_DIM = 12, 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_ms(fn, iters=20, reps=7):
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, so no host work sits between the launches, the graph
    replayed ``reps`` times and each replay timed by CUDA events.
    Returns the median, least and largest ms per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got.float() - want.float()).abs()
    bad = err > ATOL + RTOL * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item()})")
    return err.max().item()


def kernel_phase(fa, card):
    """Phase 3: each kernel against its plain version, timed."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    rows = {}

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # K1 at the prefill / predict shapes; q, k, v are views of one fused
    # qkv buffer exactly as the projection produces them
    for b, t, label in ((2, 1024, "causal_T1024"), (1, 200, "ragged_T200")):
        qkv = rand(b, t, 3 * HEADS * HEAD_DIM)
        q, k, v = (x.unflatten(-1, (HEADS, HEAD_DIM))
                   for x in qkv.split(HEADS * HEAD_DIM, dim=-1))
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_reference(q, k, v, causal=True)
        err = check_close(f"flash_attention {label}", got, want)
        ms, lo, hi = device_ms(lambda: fa.flash_attention(q, k, v, True))
        plain = device_ms(lambda: fa.flash_attention_reference(
            q, k, v, True))[0]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = device_ms(lambda: torch.nn.functional
                        .scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True))[0]
        n = b * t * HEADS * HEAD_DIM
        bms, by = bound(4 * n * 4, 4 * b * HEADS * HEAD_DIM * t * (t + 1) / 2)
        row = dict(name="flash_attention", case=label, max_abs_err=err,
                   ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain,
                   bound_ms=bms, bound_by=by, library_ms=lib, card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault("flash_attention", row)

    # K2: 8 slots plus the trash row against a 1024-position cache
    b, t = 9, 1024
    q = rand(b, 1, HEADS, HEAD_DIM)
    k, v = rand(b, t, HEADS, HEAD_DIM), rand(b, t, HEADS, HEAD_DIM)
    pos = torch.randint(0, t, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1] = 0, t - 1
    got = fa.flash_decode_attention(q, k, v, pos)
    want = fa.flash_decode_attention_reference(q, k, v, pos)
    err = check_close("flash_decode_attention", got, want)
    ms, lo, hi = device_ms(lambda: fa.flash_decode_attention(q, k, v, pos))
    plain = device_ms(lambda: fa.flash_decode_attention_reference(
        q, k, v, pos))[0]
    mask = (torch.arange(t, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = device_ms(lambda: torch.nn.functional
                    .scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask))[0]
    vis = int((pos.long() + 1).clamp(max=t).sum())
    row_bytes = HEADS * HEAD_DIM * 4
    bms, by = bound(2 * vis * row_bytes + 2 * b * row_bytes + 4 * b,
                    4 * vis * HEADS * HEAD_DIM)
    rows["flash_decode_attention"] = dict(
        name="flash_decode_attention", case="B9_T1024", max_abs_err=err,
        ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        card=card)
    emit({"phase": "kernel", **rows["flash_decode_attention"]})

    # K3: 8 rows over pools sized like the engine's default, shuffled
    # tables (unmapped entries name the trash block), random frontiers
    b, max_len = 8, 1024
    for bs in (16, 128):
        mb = max_len // bs
        nb = b * mb + 1
        trash = nb - 1
        kp, vp = rand(nb, bs, HEADS, HEAD_DIM), rand(nb, bs, HEADS, HEAD_DIM)
        perm = torch.randperm(nb - 1, generator=g, device=dev)
        tables = perm.reshape(b, mb).to(torch.int32)
        pos = torch.randint(0, max_len, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[0] = 0
        used = (pos.long() // bs + 1)[:, None]
        tables = torch.where(torch.arange(mb, device=dev)[None, :] < used,
                             tables, torch.full_like(tables, trash))
        q = rand(b, 1, HEADS, HEAD_DIM)
        got = fa.flash_paged_decode_attention(q, kp, vp, tables, pos)
        want = fa.flash_paged_decode_attention_reference(q, kp, vp, tables,
                                                         pos)
        err = check_close(f"flash_paged_decode_attention bs{bs}", got, want)
        ms, lo, hi = device_ms(lambda: fa.flash_paged_decode_attention(
            q, kp, vp, tables, pos))
        plain = device_ms(lambda: fa
                          .flash_paged_decode_attention_reference(
                              q, kp, vp, tables, pos))[0]
        vis = int((pos.long() + 1).sum())
        bms, by = bound(2 * vis * row_bytes + 2 * b * row_bytes + 4 * b
                        + 4 * int(used.sum()), 4 * vis * HEADS * HEAD_DIM)
        # no single PyTorch call reads K/V through block tables
        row = dict(name="flash_paged_decode_attention", case=f"B8_bs{bs}",
                   max_abs_err=err, ms=ms, ms_min=lo, ms_max=hi,
                   plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, card=card)
        emit({"phase": "kernel", **row})
        rows.setdefault("flash_paged_decode_attention", row)
    return rows


def clone_tree(tree):
    return {name: {kv: t.clone() for kv, t in layer.items()}
            for name, layer in tree.items()}


def served_step_errors(engines, model, plain, prompts, max_new):
    """Phase 5: one greedy burst through the paged and the contiguous
    kernel engines, in which every step the model serves (chunk prefill
    and decode through the pool, prefill and decode through the cache) is
    also run by the plain model on a copy of the cache taken just before
    it.  Only the logits of real tokens are held: a padding row or token
    reads the trash block or trash row, where duplicate writes land in
    no set order.  Returns the largest abs logit error of each kind of
    step and the two engines' streams."""
    errs = {}

    def note(kind, got, want):
        err = check_close(f"served {kind} logits", got, want)
        errs[kind] = max(errs.get(kind, 0.0), err)

    served_paged, served_forward = model.apply_paged, model.forward

    def apply_paged(input, pool, tables, *, pos, lengths=None):
        before = clone_tree(pool)
        logits, pool = served_paged(input, pool, tables, pos=pos,
                                    lengths=lengths)
        want, _ = plain.apply_paged(input, before, tables, pos=pos,
                                    lengths=lengths)
        trash = next(iter(pool.values()))["k"].shape[0] - 1
        keep = (tables[:, 0] != trash)[:, None]     # a padding row: all trash
        if lengths is None:
            kind = "paged_decode"
        else:
            kind = "paged_chunk_prefill"
            steps = torch.arange(input.shape[1], device=keep.device)
            keep = keep & (steps[None, :] < lengths[:, None])
        note(kind, logits[keep], want[keep])
        return logits, pool

    def forward(input, cache=None, pos=None):
        if cache is None:
            return served_forward(input)
        before = clone_tree(cache)
        logits, cache = served_forward(input, cache=cache, pos=pos)
        want, _ = plain(input, cache=before, pos=pos)
        if pos is None:
            note("contiguous_prefill", logits, want)
        else:                           # the last row is the trash row
            note("contiguous_decode", logits[:-1], want[:-1])
        return logits, cache

    model.apply_paged, model.forward = apply_paged, forward
    streams = {}
    try:
        for label in ("paged", "contiguous"):
            futs = [engines[label].generate(p, max_new_tokens=max_new)
                    for p in prompts]
            streams[label] = [f.result(600) for f in futs]
    finally:
        del model.apply_paged, model.forward
    kinds = ("paged_chunk_prefill", "paged_decode", "contiguous_prefill",
             "contiguous_decode")
    if sorted(errs) != sorted(kinds):
        raise AssertionError(f"served steps checked: {sorted(errs)}")
    return errs, streams


def e2e_phase(fa, card):
    """Phase 4: TransformerLM "small" through three engines and predict."""
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
    from bigdl_tpu_torch.serving import ServingEngine

    vocab, max_new = 32000, 32
    t0 = time.perf_counter()
    model = transformer_lm("small", vocab_size=vocab, device="cuda", seed=0)
    plain_model = transformer_lm("small", vocab_size=vocab, device="cuda",
                                 seed=0, use_flash="never")
    emit({"phase": "e2e_setup", "model": "small",
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": time.perf_counter() - t0})
    toks, _ = synthetic_corpus(8, 700, vocab, seed=1)
    lengths = np.linspace(17, 700, 8).astype(int)
    prompts = [toks[i, :n] for i, n in enumerate(lengths)]
    seq512, _ = synthetic_corpus(1, 512, vocab, seed=2)
    seq200, _ = synthetic_corpus(1, 200, vocab, seed=3)
    # fresh prompts for phase 5, so no prefix-cache hit shortens prefill
    toks5, _ = synthetic_corpus(8, 700, vocab, seed=4)
    prompts5 = [toks5[i, :n] for i, n in enumerate(lengths)]

    engines = {
        "paged": ServingEngine(model, decode_slots=8, decode_max_len=1024),
        "contiguous": ServingEngine(model, decode_slots=8,
                                    decode_max_len=1024,
                                    kv_cache="contiguous"),
        "paged_plain": ServingEngine(plain_model, decode_slots=8,
                                     decode_max_len=1024),
    }
    try:
        for eng in engines.values():
            eng.precompile()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        streams, sampled = {}, {}
        fa.reset_launch_counts()
        # ---- the main path: counts read right after it ----------------
        # two rounds in turn (paged, contiguous, plain, paged, ...): the
        # first rounds' numbers carry the first use of each shape
        for rnd in (0, 1):
            for label, eng in engines.items():
                t0 = time.perf_counter()
                futs = [eng.generate(p, max_new_tokens=max_new)
                        for p in prompts]
                out = [f.result(600) for f in futs]
                wall = time.perf_counter() - t0
                streams[(label, rnd)] = out
                n_tok = sum(len(s) for s in out)
                ttft = sorted(f.first_token_s for f in futs)
                emit({"phase": "e2e_generate", "engine": label,
                      "round": rnd, "requests": len(futs), "tokens": n_tok,
                      "wall_s": wall, "tokens_per_s": n_tok / wall,
                      "ttft_median_s": ttft[len(ttft) // 2],
                      "ttft_max_s": ttft[-1],
                      "prefix_hit_tokens": sum(f.prefix_hit_tokens
                                               for f in futs),
                      "card": card})
        eng = engines["paged"]
        for seed in (11, 12):
            sampled[seed] = eng.generate(prompts[seed % 8], max_new_tokens=
                                         max_new, temperature=0.8, top_k=50,
                                         seed=seed).result(600)
        replay = eng.generate(prompts[11 % 8], max_new_tokens=max_new,
                              temperature=0.8, top_k=50,
                              seed=11).result(600)
        logits512 = eng.predict(seq512[0], timeout=600)
        logits200 = eng.predict(seq200[0], timeout=600)
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        # -----------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        step_errs, streams5 = served_step_errors(engines, model, plain_model,
                                                 prompts5, max_new)
    finally:
        for e in engines.values():
            e.close()

    first = streams[("paged", 0)]
    if any(out != first for out in streams.values()):
        raise AssertionError(f"greedy streams differ across engines: "
                             f"{streams}")
    if not all(len(s) == max_new for s in first):
        raise AssertionError("a greedy stream stopped short")
    if replay != sampled[11]:
        raise AssertionError(f"sampled request did not replay: "
                             f"{sampled[11]} vs {replay}")
    if not all(0 <= t < vocab for s in sampled.values() for t in s):
        raise AssertionError("sampled token out of the vocabulary")
    errs = {}
    with torch.no_grad():
        for name, seq, got in (("predict_T512", seq512, logits512),
                               ("predict_T200", seq200, logits200)):
            want = plain_model(torch.as_tensor(seq, device="cuda"))[0]
            if got.shape != tuple(want.shape):
                raise AssertionError(f"{name}: shape {got.shape}")
            errs[name] = check_close(name, torch.as_tensor(got), want.cpu())
    if streams5["paged"] != streams5["contiguous"]:
        raise AssertionError(f"phase 5 greedy streams differ: {streams5}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path ({launches})")
    emit({"phase": "e2e_check", "greedy_streams_equal": True,
          "sampled_replay_equal": True, "max_abs_err_vs_plain": errs,
          "launches": launches, "peak_memory_bytes": peak,
          "distinct_greedy_tokens": len({t for s in first for t in s}),
          "first_stream": first[0][:8], "card": card})
    emit({"phase": "served_steps", "max_abs_err_vs_plain": step_errs,
          "greedy_streams_equal": True,
          "distinct_greedy_tokens": len({t for s in streams5["paged"]
                                         for t in s}), "card": card})
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log = (lib.parent / "build.log").read_text() \
        if (lib.parent / "build.log").exists() else ""
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]})

    rows = kernel_phase(fa, card)
    launches = e2e_phase(fa, card)

    replaces = {
        "flash_attention": "bigdl_tpu/ops/flash_attention.py:63",
        "flash_decode_attention": "bigdl_tpu/ops/flash_attention.py:135",
        "flash_paged_decode_attention":
            "bigdl_tpu/ops/flash_attention.py:236",
    }
    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
