#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of EE-Join on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc`` (one process per source, all at once), holds each kernel
against its plain PyTorch version on the card, then drives the
operator's entry points at full size:

* phase A: ``EEJoinOperator.prepare`` + ``execute(use_kernel=True)``,
  50,000 entities (``make_corpus``, seed 0), 1,024 documents of 512
  tokens, the pure ``index:variant`` plan (kernels fused_probe and
  jaccard_verify);
* phase C: the same corpus, plan and capacity through the streaming
  entry points: ``execute_corpus`` over the documents written as a
  ``MemmapCorpus`` under a 1 MiB device budget (4 shards of 256
  documents, each one streamed probe of 4 chunks of 64), once straight
  through and once killed after 2 shards and resumed from its lane
  checkpoints, and ``execute_sharded`` with adaptive lanes (kernels
  fused_probe_stream and jaccard_verify). Every match, score included,
  must equal phase A's;
* phase B: the first 256 documents, a hybrid plan with an ``ssjoin:lsh``
  head over entities [0, 5000) and an ``index:variant`` tail, with
  adaptive lanes. The head bands its MinHash as 2 bands x 4 rows: with
  the default 4 x 2 the head's common tokens put 268 entities in one
  signature bucket, so each window would verify K = 1,072 candidates and
  the [N, K, K] duplicate mask over N = 1 M windows would need ~1 TB.
  fused_probe is also timed at the four calls this phase makes;
* phase D: entities of 2 to 40 tokens (10,000 of them, seed 1), so
  windows are longer than the fused probe's 32-length bitmap holds:
  ``execute`` and ``execute_sharded`` through the window_filter kernel
  and jaccard_verify's kernel for rows longer than 32 tokens (its own
  row, ``jaccard_verify_long``, also checked at L = 100 on synthetic
  rows), on 32 documents of 512 tokens with an ``ssjoin:lsh`` plan
  banded 2 x 8 (see ``D_D`` below for why). The window_filter kernel is
  also checked and timed on phase A's 1,024 documents against this
  phase's filter (keys ``*_large`` of its row), and the minhash kernel on
  this phase's 655,360 windows at 2 x 8 (keys ``*_l40``);
* minhash: the ``ops.minhash`` entry point on the 1,048,576 (document,
  position, length) windows of phase B's documents, at 4 x 2 and 2 x 4
  bands, equal to the plain form and to ``window_signatures("lsh")``.

Phases A, B and D must give the matches of ``execute(use_kernel=False)``
on the card; in A and B every planted mention whose window is exactly its
entity must be found; no candidate may overflow; every kernel must have
been launched by its phase (the counts are set to 0 just before a phase
and read just after). The last two lines of standard output are a JSON
line of per-kernel numbers and ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# phase A: the configuration and batch the plan search was run for
NUM_ENTITIES = 50_000
MAX_ENTITY_LEN = 8
VOCAB = 65_536
D, T = 1_024, 512
GAMMA = 0.8
RESULT_CAPACITY = 1 << 19  # phase A finds ~268,000 matches, more than 2^18
# phase B: hybrid split over the first D_B documents
D_B = 256
SPLIT_B = 5_000
LSH_B = (2, 4)  # bands, rows of the ssjoin:lsh head (see the module docstring)

# phase C: execute_corpus under this device budget -> 4 shards of 256 docs
BUDGET_C = 1 << 20
SHARD_C, TILE_C = 256, 64
# phase D: long entities. The plain comparator (execute(use_kernel=False))
# builds three [N, K, L, L] bool tensors in its similarity: at L = 40,
# K = 10 (2 x 8 bands) and N = D*T*L that is 31 GB at D = 32, so D is cut
# from 256 to 32. Variant plans are out: their enumeration grows
# combinatorially with entity length.
NUM_ENTITIES_D = 10_000
MAX_ENTITY_LEN_D = 40
D_D = 32
LSH_D = (2, 8)
# minhash: the windows of phase B's documents
MINHASH_BANDS = ((4, 2), (2, 4))

DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
# The data sheet gives no int32 rate. An SM dispatches at most four 32-lane
# instructions a clock; integer multiply-adds (IMAD, and adds the compiler
# turns into them) go to the FMA pipe and logic, shift and min to the ALU
# pipe, so a mix of both reaches that dispatch rate: 132 SMs x 128 lanes at
# the 1.98 GHz boost clock of the SXM part. (64 lanes, the ALU pipe alone,
# is no peak: minhash's hash loop runs above it.)
INT32_OPS_PER_S = 132 * 128 * 1.98e9

# A wrong kernel is the failure this script exists to catch: every check
# raises, and the result lines print only after all of them passed.


def fail(msg: str) -> None:
    raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, host: list | None = None) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up;
    ``host``, where given, receives the host time of each run in ms."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        if host is not None:
            host.append((time.perf_counter() - t) * 1e3)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int):
    """Device time per call of ``fn``: the CUDA kernels and memsets that
    torch.profiler records over ``reps`` calls after one warm-up, summed
    over ``reps``; also by name. Free of the host time between launches,
    which a short kernel's event timing includes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].strip()
            by_name[name] = by_name.get(name, 0.0) + ev.device_time_total / 1e3 / reps
    return sum(by_name.values()), by_name


def max_abs_diff(a, b) -> float:
    import torch

    if a is None or b is None:
        if a is not None or b is not None:
            fail("one form returned an output the other did not")
        return 0.0
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype differ: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def counters():
    """Each kernel's launch counter: name -> (module, attribute)."""
    from repro_torch.kernels import fused_probe, jaccard_verify, minhash, window_filter

    return {"fused_probe": (fused_probe, "launches"),
            "fused_probe_stream": (fused_probe, "stream_launches"),
            "jaccard_verify": (jaccard_verify, "launches"),
            "jaccard_verify_long": (jaccard_verify, "long_launches"),
            "window_filter": (window_filter, "launches"),
            "minhash": (minhash, "launches")}


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts(names) -> dict:
    c = counters()
    return {n: getattr(*c[n]) for n in names}


def require_launched(counts: dict, tag: str) -> None:
    for name, n in counts.items():
        if n == 0:
            fail(f"{tag}: the {name} kernel was not launched")


class KernelReport:
    """Per-kernel numbers for the JSON line."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def set(self, name: str, **kw) -> None:
        self.rows.setdefault(name, {"name": name}).update(kw)

    def worst_err(self, name: str, err: float) -> None:
        row = self.rows.setdefault(name, {"name": name})
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)


def check_fused_probe(report, docs, flt, NC, L, lsh, tag):
    """Every mode of the probe kernel == its plain version, bit for bit."""
    import torch

    from repro_torch.kernels import fused_probe as fp

    Dd, Tt = docs.shape
    bits, num_bits, num_hashes = flt
    bd_nc = fp.compact_tile_height(Dd, Tt, NC)
    rng = torch.Generator(device="cpu").manual_seed(1)
    big = torch.randint(-2**31, 2**31 - 1, ((1 << 22) // 32,), generator=rng,
                        dtype=torch.int64).to(torch.int32).to(docs.device)
    cases = [
        ("none", 0, False, fp.DEFAULT_BD, flt),
        ("none", NC, True, bd_nc, flt),
        ("none", NC, False, bd_nc, flt),
        ("none", NC, False, bd_nc, (big, 1 << 22, num_hashes)),  # Bloom words in global memory
        ("lsh", 0, False, fp.DEFAULT_BD, flt),
        ("lsh", NC, False, bd_nc, flt),
        ("variant", 0, False, fp.DEFAULT_BD, flt),
        ("variant", NC, False, bd_nc, flt),
        ("variant", 4096, False, fp.DEFAULT_BD, flt),  # many tiles, overflowing lanes
        ("variant", 24 * Tt * L, False, 24, flt),  # a short last tile (D % 24 != 0)
        ("variant", 2 * 8 * Tt * L, False, 8, flt),  # lanes past every tile's capacity
        (None, None, None, None, None),  # variant lanes at the adaptive width
    ]
    if Dd % 24 == 0:
        fail(f"fused_probe {tag}: D={Dd} leaves no short last tile at bd=24")
    for mode, C, count_only, bd, f in cases:
        if mode is None:
            counts = fp.fused_probe_cuda(docs, bits, num_bits, num_hashes, L, candidates=NC,
                                         bd=bd_nc, count_only=True)[2]
            mode, C, count_only, bd, f = ("variant", fp.round_lane_width(int(counts.max()), NC),
                                          False, bd_nc, flt)
        kw = dict(max_len=L, sig_mode=mode, bands=lsh.bands, rows=lsh.rows, use_filter=True, bd=bd,
                  candidates=C, count_only=count_only)
        got = fp.fused_probe_cuda(docs, f[0], f[1], f[2], **kw)
        want = fp.fused_probe_plain(docs, f[0], f[1], f[2], **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("packed", "sigs", "counts", "cands", "vkeys"), got, want):
            err = max_abs_diff(g, w)
            if err != 0.0:
                fail(f"fused_probe {tag} mode={mode} C={C} count_only={count_only} "
                     f"bd={bd} bits={f[1]}: {name} differs from the plain version ({err})")
            report.worst_err("fused_probe", err)
        del got, want
    log(f"[check] fused_probe {tag}: {len(cases)} modes bit-identical to the plain version")


def check_jaccard(report, inputs, tag):
    """The verify kernel == its plain version: within 1e-6 for rows of up
    to 32 tokens, bit for bit for longer rows (the long-row kernel).

    Both sum in index order with exact products and divide in IEEE
    single precision, so they should agree exactly; 1e-6 is the verify
    tolerance the tests hold the port to against the reference.
    """
    import torch

    from repro_torch.kernels import jaccard_verify as jv

    L = inputs[2].shape[2]
    name, tol = ("jaccard_verify_long", 0.0) if L > jv.MAX_UNROLLED_L else ("jaccard_verify", 1e-6)
    for mode in jv.MODES:
        got = jv.jaccard_verify_cuda(*inputs, mode=mode)
        want = jv.jaccard_verify_plain(*inputs, mode=mode)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name} {tag} {mode}: non-finite scores")
        err = max_abs_diff(got, want)
        if err > tol:
            fail(f"{name} {tag} {mode}: differs from the plain version by {err}")
        report.worst_err(name, err)
        del got, want
    log(f"[check] {name} {tag}: N={inputs[2].shape[0]} K={inputs[2].shape[1]} "
        f"L={L} within {tol:g} of the plain version")


def check_jaccard_long_synthetic(report, dev, N=8192, K=10, L=100):
    """The long-row kernel at L = 100 on synthetic rows: windows of real
    tokens then a PAD tail (longer than the 64 window tokens the kernel
    keeps in registers), entity rows drawn half from their window."""
    import numpy as np
    import torch

    rng = np.random.default_rng(100)
    win = rng.integers(1, 5000, size=(N, L)).astype(np.int32)
    win[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=(N, 1))] = 0
    ent = rng.integers(1, 5000, size=(N, K, L)).astype(np.int32)
    pick = rng.integers(0, L, size=(N, K, L))
    from_win = np.take_along_axis(np.broadcast_to(win[:, None, :], (N, K, L)), pick, axis=2)
    ent = np.where(rng.random((N, K, L)) < 0.5, from_win, ent)
    ent[np.arange(L)[None, None, :] >= rng.integers(1, L + 1, size=(N, K, 1))] = 0
    win_w = (rng.uniform(0.1, 2.0, (N, L)) * (win != 0)).astype(np.float32)
    ent_w = (rng.uniform(0.1, 2.0, (N, K, L)) * (ent != 0)).astype(np.float32)
    check_jaccard(report, [torch.as_tensor(a, device=dev) for a in (win, win_w, ent, ent_w)],
                  "synthetic")


def verify_inputs_of(prepared, docs, side_index):
    """The jaccard_verify inputs the main path builds for one side: one
    tuple for each index partition or signature table the side probes,
    through the engine's own probe step."""
    from repro_torch.core.eejoin import side_sources
    from repro_torch.extraction import engine
    from repro_torch.kernels import ops

    side = prepared.sides[side_index]
    cands = engine.fused_filter_compact(docs, prepared.max_entity_len, side.flt, side.params)
    out = []
    for source in side_sources(side):
        toks, _, ent_ids, _ = engine.candidate_pairs(cands, source, side.ddict, side.params)
        out.append(ops.jaccard_verify_inputs(toks, ent_ids, side.ddict.tokens,
                                             side.ddict.token_weight))
    return out


def check_verify_of(report, prepared, docs, tag):
    """jaccard_verify at every shape the main path gives it; returns the
    largest inputs for timing."""
    largest = None
    for i in range(len(prepared.sides)):
        for j, inputs in enumerate(verify_inputs_of(prepared, docs, i)):
            check_jaccard(report, inputs, f"{tag} side {i} source {j}")
            if largest is None or inputs[2].numel() > largest[2].numel():
                largest = inputs
    return largest


def time_probe(tag, call, docs, bits):
    """One fused_probe call at its shapes: event time per call over 20
    back-to-back calls (returned, the kernels line's ms), the host time
    of each of those calls, the device time per call by kernel
    (torch.profiler, returned) and the bytes bound at the function's own
    widths (bytes returned) and at the int64 slots the contract writes."""
    import torch

    host: list[float] = []
    ms = cuda_time_ms(call, 20, host)
    dev, parts = device_ms(call, 20)
    out = call()
    torch.cuda.synchronize()
    Dd, Tt = docs.shape
    # docs and Bloom words read once; the outputs written once, at the
    # function's widths (packed, sigs and keys uint32, counts and lanes
    # int32) and at the port's (packed, sigs and keys in int64 slots)
    read = Dd * Tt * 4 + bits.numel() * 4
    own = read + sum(t.numel() * 4 for t in out if t is not None)
    slots = read + sum(t.numel() * t.element_size() for t in out if t is not None)
    log(f"[time] fused_probe {tag}: event {ms:.4f} ms per call; device {dev:.4f} ms per call "
        "(torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"); host to enqueue one: median {statistics.median(host):.4f} ms, max "
        f"{max(host):.4f} ms; bytes bound {own / HBM_BYTES_PER_S * 1e3:.4f} ms ({own} B) at the "
        f"function's widths, {slots / HBM_BYTES_PER_S * 1e3:.4f} ms ({slots} B) at the int64 "
        "slots")
    return ms, dev, own


def time_probe_b(docs, prepared, NC, L, lsh):
    """fused_probe at phase B's four calls: count-only, then lanes at the
    adaptive width, for the lsh head (dense signatures) and the variant
    tail."""
    from repro_torch.kernels import fused_probe as fp

    Dd, Tt = docs.shape
    bd = fp.compact_tile_height(Dd, Tt, NC)
    for tag, side, mode in (("B head", 0, "lsh"), ("B tail", 1, "variant")):
        bits, num_bits, num_hashes = prepared.sides[side].flt
        kw = dict(max_len=L, bands=lsh.bands, rows=lsh.rows, bd=bd)
        count = lambda: fp.fused_probe_cuda(docs, bits, num_bits, num_hashes, candidates=NC,
                                            count_only=True, **kw)
        time_probe(f"{tag} count-only D={Dd} bd={bd}", count, docs, bits)
        width = fp.round_lane_width(int(count()[2].max()), NC)
        time_probe(f"{tag} {mode} lanes C={width}",
                   lambda: fp.fused_probe_cuda(docs, bits, num_bits, num_hashes, sig_mode=mode,
                                               candidates=width, **kw), docs, bits)


def time_kernels(report, docs, flt, NC, L, verify_inputs):
    """Kernel, plain and bound times at the main path's shapes."""
    from repro_torch.kernels import fused_probe as fp
    from repro_torch.kernels import jaccard_verify as jv

    Dd, Tt = docs.shape
    bits, num_bits, num_hashes = flt
    bd = fp.compact_tile_height(Dd, Tt, NC)
    G = -(-Dd // bd)
    kw = dict(max_len=L, sig_mode="variant", use_filter=True, bd=bd, candidates=NC)
    tag = f"variant lanes D={Dd} T={Tt} L={L} NC={NC} G={G} bd={bd}"
    ms, dev, nbytes = time_probe(tag, lambda: fp.fused_probe_cuda(docs, bits, num_bits,
                                                                 num_hashes, **kw), docs, bits)
    plain = cuda_time_ms(lambda: fp.fused_probe_plain(docs, bits, num_bits, num_hashes, **kw), 3)
    ops = probe_ops(Dd * Tt, L)
    b = bound(report, "fused_probe", nbytes, ops)
    report.set("fused_probe", route="cuda", source="src/repro_torch/kernels/csrc/fused_probe.cu",
               replaces="src/repro/kernels/fused_probe.py:561", ms=ms, device_ms=dev,
               plain_ms=plain, library_ms=None)
    log(f"[time] fused_probe {tag}: kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {b:.4f} ms "
        f"({nbytes} B, {ops} ops)")

    N, K, Lv = verify_inputs[2].shape
    ms = cuda_time_ms(lambda: jv.jaccard_verify_cuda(*verify_inputs, mode="extra"), 20)
    plain = cuda_time_ms(lambda: jv.jaccard_verify_plain(*verify_inputs, mode="extra"), 3)
    nbytes = N * K * Lv * 8 + N * Lv * 8 + N * K * 4
    # per pair: L x L int32 token compares; ~3 float32 operations per
    # entity position and 2 for the quotient. The two kinds of unit run
    # side by side, so the slower one bounds.
    int_ops, f32_ops = N * K * Lv * Lv, N * K * (3 * Lv + 2)
    b = bound(report, "jaccard_verify", nbytes, int_ops, f32_ops)
    report.set("jaccard_verify", route="cuda",
               source="src/repro_torch/kernels/csrc/jaccard_verify.cu",
               replaces="src/repro/kernels/jaccard_verify.py:83", ms=ms, plain_ms=plain,
               library_ms=None)
    log(f"[time] jaccard_verify N={N} K={K} L={Lv}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
        f"bound {b:.4f} ms ({nbytes} B, {int_ops + f32_ops} ops); "
        "no single PyTorch call computes either kernel's function (library_ms null)")


OWN_KERNELS = ("fused_probe_kernel", "jaccard_kernel",
               "jaccard_long_kernel", "stream_probe_kernel", "lane_fill_kernel",
               "window_filter_kernel", "minhash_kernel")


def profile_call(tag, what, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        row = by_name.setdefault(ev.name, [0.0, 0])
        row[0] += ev.device_time_total / 1e3
        row[1] += 1
    total = sum(v[0] for v in by_name.values())
    if total == 0.0:
        log(f"[{tag}] profile: device time not measured (the profiler recorded no CUDA events)")
        return
    own = sum(v[0] for k, v in by_name.items() if any(o in k for o in OWN_KERNELS))
    log(f"[{tag}] profile of one {what}: wall {wall_ms:.3f} ms, device busy {total:.3f} ms "
        f"({100 * total / wall_ms:.1f}%, idle {100 * (1 - total / wall_ms):.1f}%), "
        f"CUDA kernels of repro_torch {own:.3f} ms ({100 * own / total:.1f}% of device time), "
        f"{sum(v[1] for v in by_name.values())} device ops")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag}]   {ms:9.3f} ms  x{n:<4d} {name[:90]}")


def match_scores(m):
    keep = (m.doc >= 0).cpu()
    cols = [t.cpu()[keep].tolist() for t in (m.doc, m.pos, m.length, m.entity)]
    return dict(zip(zip(*cols), m.score.cpu()[keep].tolist()))


def compare_matches(got, want, gamma_of_entity, tag):
    """Equal match sets; a differing hit may only be an f32 tie at gamma."""
    gs, ws = match_scores(got), match_scores(want)
    differ = set(gs) ^ set(ws)
    ties = {k for k in differ
            if gamma_of_entity(k[3]) > 0 and abs(ws.get(k, gs.get(k)) - gamma_of_entity(k[3])) <= 1e-5}
    if differ - ties:
        fail(f"{tag}: kernel and plain match sets differ in {len(differ - ties)} hits, "
             f"e.g. {sorted(differ - ties)[:3]}")
    worst = max((abs(gs[k] - ws[k]) for k in set(gs) & set(ws)), default=0.0)
    if worst > 1e-6:
        fail(f"{tag}: a shared hit's score differs from the plain path's by {worst}")
    log(f"[check] {tag}: {len(gs)} matches equal to the plain path "
        f"({len(ties)} threshold ties, worst score difference {worst:.3g})")


def check_planted(m, corpus, docs_np, L, entity_range, tag):
    """Planted mentions whose window is exactly the entity's token set are
    Jaccard variants (Def. 2) and must be found."""
    d = corpus.dictionary
    found = set(match_scores(m))
    want = 0
    for doc, pos, n, e in corpus.planted:
        if doc >= docs_np.shape[0] or n > L or not entity_range[0] <= e < entity_range[1]:
            continue
        win = docs_np[doc, pos:pos + n]
        if sorted(win.tolist()) != sorted(d.tokens[e, :d.lengths[e]].tolist()) or len(set(win.tolist())) != n:
            continue
        want += 1
        if (doc, pos, n, e) not in found:
            fail(f"{tag}: exact planted mention {(doc, pos, n, e)} not extracted")
    if want == 0:
        fail(f"{tag}: no exact planted mention to check")
    log(f"[check] {tag}: all {want} exact planted mentions extracted")


def check_matches_shape(m, Dd, Tt, L, tag):
    import torch

    n = int(m.count)
    if n > RESULT_CAPACITY:
        fail(f"{tag}: {n} matches overflow result_capacity {RESULT_CAPACITY}")
    live = m.doc >= 0
    if int(live.sum()) != n:
        fail(f"{tag}: {int(live.sum())} live rows but count {n}")
    s = m.score[live]
    if not (torch.isfinite(s).all() and (s >= 0).all() and (s <= 1 + 1e-6).all()):
        fail(f"{tag}: scores outside [0, 1]")
    if not ((m.doc[live] < Dd).all() and (m.pos[live] < Tt).all() and (m.length[live] >= 1).all()
            and (m.length[live] <= L).all()):
        fail(f"{tag}: match coordinates out of range")


def plain_prepared(prepared):
    """The same prepared structures with the kernels switched off."""
    sides = [dataclasses.replace(s, params=dataclasses.replace(
        s.params, use_kernel=False, kernel_compact=False, adaptive_lanes=False, lane_width=None))
        for s in prepared.sides]
    return dataclasses.replace(prepared, sides=sides)


def run_phase(tag, op, op_plain, prepared, docs, corpus, docs_np, entity_gamma, entity_range,
              kernels):
    """Drive one phase through the public entry point and check it."""
    import torch

    from repro_torch.extraction import engine
    from repro_torch.kernels.fused_probe import compact_tile_height

    L = prepared.max_entity_len
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = op.execute(prepared, docs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    require_launched(launches, f"{tag} execute")
    log(f"[{tag}] execute(use_kernel=True) first call {first_s:.3f} s, launches {launches}, "
        f"{int(m.count)} matches")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op.execute(prepared, docs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[{tag}] execute median {statistics.median(times):.3f} ms over 5 runs "
        f"(runs: {', '.join(f'{t:.3f}' for t in times)})")

    profile_call(tag, "execute", lambda: op.execute(prepared, docs))

    for i, side in enumerate(prepared.sides):
        c = engine.fused_filter_compact(docs, L, side.flt, side.params)
        n, over = int(c["n_survive"]), int(c["overflow"])
        NC = side.params.max_candidates
        bd = compact_tile_height(docs.shape[0], docs.shape[1], NC)
        K = (side.index_parts[0].ents.shape[1] if side.index_parts is not None
             else side.sig_table.bucket_cap * (side.params.lsh.bands if side.side.scheme == "lsh"
                                                else 1))
        log(f"[{tag}] side {i} {side.side}: survivors {n} of {docs.numel() * L} windows "
            f"(density {n / (docs.numel() * L):.4f}), NC {NC}, G {-(-docs.shape[0] // bd)}, "
            f"bd {bd}, verify K {K}, overflow {over}")
        if over != 0:
            fail(f"{tag}: candidate overflow {over} on side {i}")

    check_matches_shape(m, docs.shape[0], docs.shape[1], L, tag)
    m_plain = op_plain.execute(plain_prepared(prepared), docs)
    torch.cuda.synchronize()
    compare_matches(m, m_plain, entity_gamma, tag)
    check_planted(m, corpus, docs_np, L, entity_range, tag)
    return m, launches, times


def probe_ops(positions: int, L: int) -> int:
    """int32 operations of the probe recurrence: per token 3 Bloom hashes
    + 2 variant hashes (~10 ops each) and 3 probes; per (token, length)
    the recurrence (~24 ops)."""
    return positions * (5 * 10 + 3 * 4) + positions * L * 24


def bound(report, name, nbytes, int_ops, f32_ops=0):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over their type's peak rate."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / FP32_OPS_PER_S) * 1e3
    report.set(name, bound_ms=max(b_bytes, b_ops),
               bound_by="bytes" if b_bytes >= b_ops else "operations")
    return max(b_bytes, b_ops)


def compare_exact(got, want_scores, tag, ref="phase A's"):
    """The same matches with bit-identical scores."""
    gs = match_scores(got)
    if gs != want_scores:
        differ = set(gs) ^ set(want_scores)
        worst = max((abs(gs[k] - want_scores[k]) for k in set(gs) & set(want_scores)),
                    default=0.0)
        fail(f"{tag}: {len(differ)} matches differ from {ref} (e.g. {sorted(differ)[:3]}), "
             f"worst shared score difference {worst}")
    log(f"[check] {tag}: {len(gs)} matches equal to {ref}, scores bit-identical")


def phase_c(report, op, prepared, docs, corpus_docs, want_scores, NC, L):
    """execute_corpus (straight, then killed and resumed) and
    execute_sharded with adaptive lanes, through the streamed probe."""
    import tempfile

    import torch

    from repro_torch.core.eejoin import EEJoinOperator
    from repro_torch.extraction import engine, sharded
    from repro_torch.kernels import fused_probe as fp

    # B3 against its plain form at one shard's shapes (shard 1: row base 256)
    flt = prepared.sides[0].flt
    bits, num_bits, num_hashes = flt
    bd = fp.compact_tile_height(TILE_C, docs.shape[1], NC)
    sdocs, offs = sharded._streamed_layout(docs[SHARD_C:2 * SHARD_C].contiguous(), TILE_C,
                                           SHARD_C // TILE_C, bd)
    row_offs = torch.as_tensor(offs + SHARD_C, device=docs.device)
    for mode, count_only in (("variant", False), ("none", True), ("none", False)):
        kw = dict(max_len=L, sig_mode=mode, bd=bd, candidates=NC, count_only=count_only)
        got = fp.fused_probe_stream_cuda(sdocs, bits, row_offs, num_bits, num_hashes, **kw)
        want = fp.fused_probe_stream_plain(sdocs, bits, row_offs, num_bits, num_hashes, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("counts", "cands", "vkeys"), got, want):
            err = max_abs_diff(g, w)
            if err != 0.0:
                fail(f"fused_probe_stream mode={mode} count_only={count_only}: {name} differs "
                     f"from the plain version ({err})")
            report.worst_err("fused_probe_stream", err)
        del got, want
    log(f"[check] fused_probe_stream: shard of {SHARD_C} docs, G={len(offs)} chunks of bd={bd}, "
        "variant lanes, count-only and plain lanes bit-identical to the plain version")

    kw = dict(max_len=L, sig_mode="variant", bd=bd, candidates=NC)
    ms = cuda_time_ms(lambda: fp.fused_probe_stream_cuda(sdocs, bits, row_offs, num_bits,
                                                         num_hashes, **kw), 20)
    plain = cuda_time_ms(lambda: fp.fused_probe_stream_plain(sdocs, bits, row_offs, num_bits,
                                                             num_hashes, **kw), 3)
    R, Tt = sdocs.shape
    G = len(offs)
    # docs, Bloom words and row offsets read once; counts [G] i32, lanes
    # [G, C] i32 and variant keys [G, C, 2] u32 written once
    nbytes = R * Tt * 4 + bits.numel() * 4 + G * 4 + G * 4 + G * NC * 4 + G * NC * 8
    b = bound(report, "fused_probe_stream", nbytes, probe_ops(R * Tt, L))
    report.set("fused_probe_stream", route="cuda",
               source="src/repro_torch/kernels/csrc/fused_probe_stream.cu",
               replaces="src/repro/kernels/fused_probe.py:777", ms=ms, plain_ms=plain,
               library_ms=None)
    log(f"[time] fused_probe_stream variant lanes R={R} T={Tt} L={L} G={G} bd={bd} W={NC}: "
        f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {b:.4f} ms ({nbytes} B)")
    kw = dict(max_len=L, bd=bd, candidates=NC, count_only=True)
    ms_count = cuda_time_ms(lambda: fp.fused_probe_stream_cuda(sdocs, bits, row_offs, num_bits,
                                                               num_hashes, **kw), 20)
    plain_count = cuda_time_ms(lambda: fp.fused_probe_stream_plain(sdocs, bits, row_offs,
                                                                   num_bits, num_hashes, **kw), 3)
    nbytes = R * Tt * 4 + bits.numel() * 4 + G * 4 + G * 4
    log(f"[time] fused_probe_stream count-only R={R} T={Tt} L={L} G={G} bd={bd}: kernel "
        f"{ms_count:.4f} ms, plain {plain_count:.3f} ms, bytes bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B)")
    for what, count_only in (("variant lanes", False), ("count-only", True)):
        kw = dict(max_len=L, sig_mode="none" if count_only else "variant", bd=bd, candidates=NC,
                  count_only=count_only)
        total, parts = device_ms(lambda: fp.fused_probe_stream_cuda(
            sdocs, bits, row_offs, num_bits, num_hashes, **kw), 20)
        log(f"[time] fused_probe_stream {what}: device time {total:.4f} ms per call "
            f"(torch.profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + ")")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_c_")
    try:
        mc = sharded.MemmapCorpus.write(f"{tmp}/corpus", corpus_docs)
        op_c = EEJoinOperator(op.dictionary, dataclasses.replace(op.config,
                                                                 device_budget_bytes=BUDGET_C),
                              device=docs.device)
        names = ("fused_probe_stream", "jaccard_verify")

        reset_counts()
        stats: dict = {}
        t0 = time.perf_counter()
        m = op_c.execute_corpus(prepared, mc, stream_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        straight = read_counts(names)
        require_launched(straight, "C execute_corpus")
        log(f"[C] execute_corpus (budget {BUDGET_C} B) {wall:.3f} s, launches {straight}, "
            f"stats {stats}")
        compare_exact(m, want_scores, "C execute_corpus")
        if stats.get("streamed_launches") != 4 or stats.get("tiles_streamed") != 16:
            fail(f"C execute_corpus: expected 4 streamed launches of 4 chunks, got {stats}")
        del m
        profile_call("C", "execute_corpus", lambda: op_c.execute_corpus(prepared, mc))
        # host clock split of one execute_corpus: the streamed front end
        # (staging, B3, lane merge, host window gather) and, inside it, the
        # window gather alone (timed over all NC window slots, sequential rows)
        side = prepared.sides[0]
        t0 = time.perf_counter()
        sharded.spill_filter_compact(mc, L, side.flt, side.params, device_budget_bytes=BUDGET_C,
                                     device=docs.device)
        torch.cuda.synchronize()
        t_front = time.perf_counter() - t0
        flat = torch.arange(NC, dtype=torch.int32, device=docs.device)
        t0 = time.perf_counter()
        engine.candidates_from_flat_host(mc.tokens, flat, flat >= 0, torch.tensor(NC), L, NC,
                                         docs.device)
        torch.cuda.synchronize()
        t_gather = time.perf_counter() - t0
        log(f"[C] host clock: spill_filter_compact (front end) {t_front:.3f} s, of which the "
            f"host window gather of {NC} slots {t_gather:.3f} s")

        reset_counts()
        ckpt = f"{tmp}/ckpt"
        try:
            op_c.execute_corpus(prepared, mc, checkpoint_dir=ckpt, fail_after_shards=2)
        except RuntimeError as e:
            if "simulated interruption" not in str(e):
                raise
        else:
            fail("C execute_corpus(fail_after_shards=2) did not stop")
        stats = {}
        t0 = time.perf_counter()
        m = op_c.execute_corpus(prepared, mc, checkpoint_dir=ckpt, stream_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        resumed = read_counts(names)
        require_launched(resumed, "C execute_corpus kill + resume")
        log(f"[C] execute_corpus killed after 2 shards, resumed in {wall:.3f} s, launches "
            f"(kill + resume) {resumed}, stats {stats}")
        if stats.get("checkpoint_hits") != 2 or stats.get("checkpoint_writes") != 2:
            fail(f"C resume: expected 2 checkpoint hits and 2 writes, got {stats}")
        compare_exact(m, want_scores, "C execute_corpus resumed")
        del m
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    adaptive = dataclasses.replace(prepared, sides=[dataclasses.replace(
        s, params=dataclasses.replace(s.params, adaptive_lanes=True)) for s in prepared.sides])
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    m = op.execute_sharded(adaptive, docs, shard_docs=SHARD_C, tile_docs=TILE_C,
                           stream_stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sharded_counts = read_counts(names)
    require_launched(sharded_counts, "C execute_sharded")
    log(f"[C] execute_sharded adaptive lanes {wall:.3f} s, launches {sharded_counts} "
        f"(count-only + emit pass per shard), stats {stats}")
    compare_exact(m, want_scores, "C execute_sharded")
    profile_call("C", "execute_sharded", lambda: op.execute_sharded(
        adaptive, docs, shard_docs=SHARD_C, tile_docs=TILE_C))
    return straight


def phase_d(report, dev, docs_a):
    """Entities of up to 40 tokens: execute and execute_sharded through
    the window_filter kernel, equal to the plain path; window_filter also
    on ``docs_a``, and the minhash kernel on this phase's windows."""
    import torch

    from repro_torch.core.cost_model import SideCost
    from repro_torch.core.eejoin import EEJoinConfig, EEJoinOperator
    from repro_torch.core.plan import Plan, PlanSide
    from repro_torch.core.signatures import LshParams
    from repro_torch.data.synth import make_corpus
    from repro_torch.extraction import engine
    from repro_torch.kernels import window_filter as wf

    t0 = time.perf_counter()
    corpus = make_corpus(num_docs=D_D, doc_len=T, vocab_size=VOCAB, num_entities=NUM_ENTITIES_D,
                         min_entity_len=2, max_entity_len=MAX_ENTITY_LEN_D, seed=1)
    L = corpus.dictionary.max_len
    log(f"[data] make_corpus E={NUM_ENTITIES_D} entity lengths 2..{MAX_ENTITY_LEN_D} D={D_D} "
        f"T={T}: {time.perf_counter() - t0:.1f} s, L={L}")
    if L <= 32:
        fail(f"D: longest entity has {L} tokens; the phase needs more than 32")
    NC = D_D * T * L
    z = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    cfg = EEJoinConfig(gamma=GAMMA, sim_name="extra", use_kernel=True, max_candidates=NC,
                       result_capacity=RESULT_CAPACITY, lsh=LshParams(*LSH_D))
    plan = Plan(0, PlanSide("ssjoin", "lsh"), PlanSide("ssjoin", "lsh"), "job_completion", 0.0,
                z, z, 0)
    op = EEJoinOperator(corpus.dictionary, cfg, device=dev)
    op_plain = EEJoinOperator(corpus.dictionary, dataclasses.replace(cfg, use_kernel=False),
                              device=dev)
    t0 = time.perf_counter()
    prepared = op.prepare(plan)
    torch.cuda.synchronize()
    side = prepared.sides[0]
    K = side.sig_table.bucket_cap * LSH_D[0]
    log(f"[D] host prepare {time.perf_counter() - t0:.1f} s (ssjoin:lsh {LSH_D[0]} x {LSH_D[1]}); "
        f"verify N={NC} K={K} L={L}: [N, K, L] inputs {NC * K * L * 8} B")
    docs = torch.as_tensor(corpus.doc_tokens, device=dev)
    bits, num_bits, num_hashes = side.flt

    # the engine's batch (D_D documents), then phase A's 1,024 documents
    # against the same filter: the size where the bytes dominate
    for tag, dd in (("", docs), ("_large", docs_a)):
        Dd = dd.shape[0]
        got = wf.window_filter_cuda(dd, bits, num_bits, num_hashes, L)
        want = wf.window_filter_plain(dd, bits, num_bits, num_hashes, L)
        torch.cuda.synchronize()
        err = max_abs_diff(got, want)
        if err != 0.0:
            fail(f"window_filter D={Dd} T={T} L={L}: differs from the plain version ({err})")
        report.worst_err("window_filter", err)
        del got, want
        log(f"[check] window_filter D={Dd} T={T} L={L}: bit-identical to the plain version")
        call = lambda: wf.window_filter_cuda(dd, bits, num_bits, num_hashes, L)  # noqa: E731
        host: list = []
        ms = cuda_time_ms(call, 50, host)
        dev_ms, _ = device_ms(call, 20)
        plain = cuda_time_ms(lambda: wf.window_filter_plain(dd, bits, num_bits, num_hashes, L), 5)
        pos = Dd * T
        # docs and Bloom words read once, the [D, T, L] bool mask written once;
        # per token 3 hashes (~10 ops) and 3 probes, per (token, length) ~2 ops
        nbytes = pos * 4 + bits.numel() * 4 + pos * L
        int_ops = pos * (3 * 10 + 3 * 4) + pos * L * 2
        if tag:
            b = max(nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
            report.set("window_filter", ms_large=ms, device_ms_large=dev_ms,
                       plain_ms_large=plain, bound_large_ms=b)
        else:
            b = bound(report, "window_filter", nbytes, int_ops)
            report.set("window_filter", route="cuda",
                       source="src/repro_torch/kernels/csrc/window_filter.cu",
                       replaces="src/repro/kernels/window_filter.py:85", ms=ms, device_ms=dev_ms,
                       plain_ms=plain, library_ms=None)
        log(f"[time] window_filter D={Dd} T={T} L={L}: kernel {ms:.4f} ms (device {dev_ms:.4f}, "
            f"host median {statistics.median(host):.4f} a call), plain {plain:.3f} ms, "
            f"bound {b:.4f} ms ({nbytes} B)")
    vin = check_verify_of(report, prepared, docs, "D")
    check_jaccard_long_synthetic(report, dev)
    from repro_torch.kernels import jaccard_verify as jv

    N, Kv, Lv = vin[2].shape
    ms = cuda_time_ms(lambda: jv.jaccard_verify_cuda(*vin, mode="extra"), 20)
    plain = cuda_time_ms(lambda: jv.jaccard_verify_plain(*vin, mode="extra"), 2)
    nbytes = N * Kv * Lv * 8 + N * Lv * 8 + N * Kv * 4
    # the same count as phase A's row: L x L int32 compares per pair and
    # ~3L + 2 float32 operations
    int_ops, f32_ops = N * Kv * Lv * Lv, N * Kv * (3 * Lv + 2)
    b = bound(report, "jaccard_verify_long", nbytes, int_ops, f32_ops)
    report.set("jaccard_verify_long", route="cuda",
               source="src/repro_torch/kernels/csrc/jaccard_verify.cu",
               replaces="src/repro/kernels/jaccard_verify.py:83", ms=ms, plain_ms=plain,
               library_ms=None)
    log(f"[time] jaccard_verify_long (rows of L={Lv} > 32) N={N} K={Kv}: kernel {ms:.4f} ms, "
        f"plain {plain:.3f} ms, bound {b:.4f} ms ({nbytes} B, {int_ops + f32_ops} ops)")
    del vin

    reset_counts()
    names = ("window_filter", "jaccard_verify", "jaccard_verify_long")
    t0 = time.perf_counter()
    m = op.execute(prepared, docs)
    torch.cuda.synchronize()
    t_exec = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_s = op.execute_sharded(prepared, docs)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    launches = read_counts(names)
    require_launched(launches, "D execute + execute_sharded")
    c = engine.fused_filter_compact(docs, L, side.flt, side.params)
    n, over = int(c["n_survive"]), int(c["overflow"])
    del c
    log(f"[D] execute {t_exec:.3f} s, execute_sharded {t_shard:.3f} s, launches {launches}, "
        f"{int(m.count)} matches; survivors {n} of {docs.numel() * L} windows, overflow {over}")
    if over != 0:
        fail(f"D: candidate overflow {over}")
    profile_call("D", "execute", lambda: op.execute(prepared, docs))
    check_matches_shape(m, D_D, T, L, "D")
    compare_exact(m_s, match_scores(m), "D execute_sharded", ref="execute's")
    m_plain = op_plain.execute(plain_prepared(prepared), docs)
    torch.cuda.synchronize()
    compare_matches(m, m_plain, lambda e: GAMMA, "D")
    if int(m.count) == 0:
        fail("D: no matches")
    check_minhash(report, *windows_of(docs, L), LSH_D, "_l40")
    return launches


def windows_of(docs, L):
    """Every (document, position, length) window of ``docs``: [N, L]
    tokens (PAD past each window's length) and their validity."""
    import torch

    from repro_torch.core.dictionary import PAD
    from repro_torch.extraction import engine

    N = docs.numel() * L
    flat = torch.arange(N, device=docs.device)
    ok = torch.ones(N, dtype=torch.bool, device=docs.device)
    win = engine.candidates_from_flat(docs, flat, ok, torch.tensor(N), L, N)["win_tokens"]
    return win, win != PAD


def check_minhash(report, win, valid, br, tag, got=None):
    """The minhash kernel's output ``got`` (computed here if None) on
    windows ``win`` at ``br`` bands x rows: equal to the plain form and to
    window_signatures('lsh'); the kernel timed beside its plain form and
    bound. ``tag`` suffixes the keys of the minhash row ("" for phase
    minhash's own shape)."""
    from repro_torch.core.signatures import LshParams, window_signatures
    from repro_torch.kernels import minhash as mh

    N, L = win.shape
    B, R = br
    if got is None:
        got = mh.minhash_cuda(win, valid, B, R)
    want = mh.minhash_plain(win, valid, B, R)
    sig, _ = window_signatures("lsh", win, valid, GAMMA, LshParams(B, R))
    err = max(max_abs_diff(got, want), max_abs_diff(got, sig))
    if err != 0.0:
        fail(f"minhash N={N} L={L} {B} x {R}: differs from the plain version or "
             f"window_signatures ({err})")
    report.worst_err("minhash", err)
    del got, want, sig
    log(f"[check] minhash N={N} L={L} {B} x {R}: bit-identical to the plain version and "
        f"window_signatures('lsh')")
    call = lambda: mh.minhash_cuda(win, valid, B, R)  # noqa: E731
    ms = cuda_time_ms(call, 50)
    dev_ms, _ = device_ms(call, 20)
    plain = cuda_time_ms(lambda: mh.minhash_plain(win, valid, B, R), 5)
    # tokens and validity bytes read once, [N, B] u32 written once; per
    # valid token B*R hashes (~10 ops) and mins, per row B*R combines
    # (~12 ops)
    nv = int(valid.sum())
    nbytes = N * L * 4 + N * L + N * B * 4
    int_ops = nv * B * R * 11 + N * (B * R + B) * 12
    if tag:
        b = max(nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
        report.set("minhash", **{f"ms{tag}": ms, f"device_ms{tag}": dev_ms,
                                 f"plain_ms{tag}": plain, f"bound{tag}_ms": b})
    else:
        b = bound(report, "minhash", nbytes, int_ops)
        report.set("minhash", route="cuda", source="src/repro_torch/kernels/csrc/minhash.cu",
                   replaces="src/repro/kernels/minhash.py:66", ms=ms, device_ms=dev_ms,
                   plain_ms=plain, library_ms=None)
    log(f"[time] minhash N={N} L={L} {B} x {R}: kernel {ms:.4f} ms (device {dev_ms:.4f}), "
        f"plain {plain:.3f} ms, bound {b:.4f} ms ({nbytes} B, {nv} valid tokens)")


def phase_minhash(report, docs_b):
    """ops.minhash on every (document, position, length) window of
    ``docs_b``, equal to the plain form and to window_signatures."""
    import torch

    from repro_torch.kernels import ops

    win, valid = windows_of(docs_b, MAX_ENTITY_LEN)
    reset_counts()
    outs = {br: ops.minhash(win, valid, *br) for br in MINHASH_BANDS}
    torch.cuda.synchronize()
    launches = read_counts(("minhash",))
    require_launched(launches, "minhash entry point")
    report.set("minhash", launches=launches["minhash"])
    log(f"[minhash] ops.minhash on {win.shape[0]} windows at {MINHASH_BANDS}: launches "
        f"{launches}; {int((~valid.any(dim=1)).sum())} windows without a valid token")
    for br in MINHASH_BANDS[::-1]:  # the row's shape (the first) last
        check_minhash(report, win, valid, br, "", got=outs.pop(br))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.cost_model import SideCost
    from repro_torch.core.eejoin import EEJoinConfig, EEJoinOperator
    from repro_torch.core.plan import Plan, PlanSide
    from repro_torch.core.signatures import LshParams
    from repro_torch.data.synth import make_corpus
    from repro_torch.kernels import _build

    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"[build] {len(build_logs)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc, sm_90a)")
    for name, text in build_logs.items():
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w in [line.split("Used ")[1].split()[0]]]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        log(f"[build] {name}: {len(regs)} kernel instances, at most {max(regs, default=0)} "
            f"registers per thread, {len(spills)} with spills")

    t0 = time.perf_counter()
    corpus = make_corpus(num_docs=D, doc_len=T, vocab_size=VOCAB, num_entities=NUM_ENTITIES,
                         max_entity_len=MAX_ENTITY_LEN, mention_dist="zipf", seed=0)
    log(f"[data] make_corpus E={NUM_ENTITIES} D={D} T={T}: {time.perf_counter() - t0:.1f} s")
    L = corpus.dictionary.max_len
    z = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    report = KernelReport()

    # ---------------------------------------------------------------- A
    NC = D * T * L  # overflow impossible
    cfg = EEJoinConfig(gamma=GAMMA, sim_name="extra", use_kernel=True, max_candidates=NC,
                       result_capacity=RESULT_CAPACITY)
    plan = Plan(0, PlanSide("index", "variant"), PlanSide("index", "variant"), "job_completion",
                0.0, z, z, 0)
    op = EEJoinOperator(corpus.dictionary, cfg, device=dev)
    op_plain = EEJoinOperator(corpus.dictionary, dataclasses.replace(cfg, use_kernel=False),
                              device=dev)
    t0 = time.perf_counter()
    prepared = op.prepare(plan)
    torch.cuda.synchronize()
    log(f"[A] host prepare {time.perf_counter() - t0:.1f} s (pure index:variant)")
    docs = torch.as_tensor(corpus.doc_tokens, device=dev)
    flt = prepared.sides[0].flt

    check_fused_probe(report, docs, flt, NC, L, cfg.lsh, "A")
    vin = check_verify_of(report, prepared, docs, "A")
    time_kernels(report, docs, flt, NC, L, vin)
    del vin
    m_a, launches_a, _ = run_phase("A", op, op_plain, prepared, docs, corpus, corpus.doc_tokens,
                                   lambda e: 0.0, (0, NUM_ENTITIES),
                                   ("fused_probe", "jaccard_verify"))
    report.set("fused_probe", launches=launches_a["fused_probe"])
    report.set("jaccard_verify", launches=launches_a["jaccard_verify"])
    want_a = match_scores(m_a)
    del m_a
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- C
    launches_c = phase_c(report, op, prepared, docs, corpus.doc_tokens, want_a, NC, L)
    report.set("fused_probe_stream", launches=launches_c["fused_probe_stream"])
    del prepared, want_a
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- B
    NC_B = D_B * T * L
    cfg_b = dataclasses.replace(cfg, max_candidates=NC_B, adaptive_lanes=True,
                                lsh=LshParams(*LSH_B))
    plan_b = Plan(SPLIT_B, PlanSide("ssjoin", "lsh"), PlanSide("index", "variant"),
                  "job_completion", 0.0, z, z, 0)
    op_b = EEJoinOperator(corpus.dictionary, cfg_b, device=dev)
    op_b_plain = EEJoinOperator(corpus.dictionary, dataclasses.replace(cfg_b, use_kernel=False,
                                                                       adaptive_lanes=False),
                                device=dev)
    t0 = time.perf_counter()
    prepared_b = op_b.prepare(plan_b)
    torch.cuda.synchronize()
    log(f"[B] host prepare {time.perf_counter() - t0:.1f} s (ssjoin:lsh head [0, {SPLIT_B}), "
        "index:variant tail)")
    docs_b = docs[:D_B].contiguous()
    check_fused_probe(report, docs_b, prepared_b.sides[0].flt, NC_B, L, cfg_b.lsh, "B head")
    time_probe_b(docs_b, prepared_b, NC_B, L, cfg_b.lsh)
    check_verify_of(report, prepared_b, docs_b, "B")
    run_phase("B", op_b, op_b_plain, prepared_b, docs_b, corpus, corpus.doc_tokens[:D_B],
              lambda e: GAMMA if e < SPLIT_B else 0.0, (0, NUM_ENTITIES),
              ("fused_probe", "jaccard_verify"))
    del prepared_b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- minhash
    phase_minhash(report, docs_b)
    del docs_b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- D
    launches_d = phase_d(report, dev, docs)
    del docs
    report.set("window_filter", launches=launches_d["window_filter"])
    report.set("jaccard_verify_long", launches=launches_d["jaccard_verify_long"])

    log(f"[total] {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    rows = [report.rows[n] for n in counters()]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # where measured: device time, and the second shapes of B4 and B5
    extra = ("device_ms", "ms_large", "device_ms_large", "plain_ms_large", "bound_large_ms",
             "ms_l40", "device_ms_l40", "plain_ms_l40", "bound_l40_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
