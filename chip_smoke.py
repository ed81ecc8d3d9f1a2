#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of EE-Join on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the
card, then drives ``EEJoinOperator.prepare`` + ``execute(use_kernel=True)``
at full size:

* phase A: 50,000 entities (``make_corpus``, seed 0), 1,024 documents of
  512 tokens, the pure ``index:variant`` plan;
* phase B: the first 256 documents, a hybrid plan with an ``ssjoin:lsh``
  head over entities [0, 5000) and an ``index:variant`` tail, with
  adaptive lanes. The head bands its MinHash as 2 bands x 4 rows: with
  the default 4 x 2 the head's common tokens put 268 entities in one
  signature bucket, so each window would verify K = 1,072 candidates and
  the [N, K, K] duplicate mask over N = 1 M windows would need ~1 TB.

Each phase's matches must equal those of ``execute(use_kernel=False)`` on
the card, every planted mention whose window is exactly its entity must
be found, no candidate may overflow, and every kernel must have been
launched by the phase. The last two lines of standard output are a JSON
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

DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
# The data sheet gives no int32 rate: 132 SMs x 64 INT32 lanes per SM at
# the 1.98 GHz boost clock of the SXM part.
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# A wrong kernel is the failure this script exists to catch: every check
# raises, and the result lines print only after all of them passed.


def fail(msg: str) -> None:
    raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
        (None, None, None, None, None),  # variant lanes at the adaptive width
    ]
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
    """The verify kernel == its plain version within 1e-6.

    Both sum in index order with exact products and divide in IEEE
    single precision, so they should agree exactly; 1e-6 is the verify
    tolerance the tests hold the port to against the reference.
    """
    import torch

    from repro_torch.kernels import jaccard_verify as jv

    for mode in jv.MODES:
        got = jv.jaccard_verify_cuda(*inputs, mode=mode)
        want = jv.jaccard_verify_plain(*inputs, mode=mode)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"jaccard_verify {tag} {mode}: non-finite scores")
        err = max_abs_diff(got, want)
        if err > 1e-6:
            fail(f"jaccard_verify {tag} {mode}: differs from the plain version by {err}")
        report.worst_err("jaccard_verify", err)
        del got, want
    log(f"[check] jaccard_verify {tag}: N={inputs[2].shape[0]} K={inputs[2].shape[1]} "
        f"L={inputs[2].shape[2]} within 1e-6 of the plain version")


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


def time_kernels(report, docs, flt, NC, L, verify_inputs):
    """Kernel, plain and bound times at the main path's shapes."""
    import torch

    from repro_torch.kernels import fused_probe as fp
    from repro_torch.kernels import jaccard_verify as jv

    Dd, Tt = docs.shape
    bits, num_bits, num_hashes = flt
    bd = fp.compact_tile_height(Dd, Tt, NC)
    G = -(-Dd // bd)
    kw = dict(max_len=L, sig_mode="variant", use_filter=True, bd=bd, candidates=NC)
    ms = cuda_time_ms(lambda: fp.fused_probe_cuda(docs, bits, num_bits, num_hashes, **kw), 20)
    plain = cuda_time_ms(lambda: fp.fused_probe_plain(docs, bits, num_bits, num_hashes, **kw), 3)
    # bytes: docs and Bloom words read once; the function's outputs at
    # their own widths written once: packed [D, T] u32, counts [G] i32,
    # lanes [G, C] i32, variant keys [G, C, 2] u32. (The port carries
    # packed and keys in int64, twice their bytes: a gap of its own.)
    nbytes = Dd * Tt * 4 + bits.numel() * 4 + Dd * Tt * 4 + G * 4 + G * NC * 4 + G * NC * 8
    # int32 operations: per token 3 Bloom hashes + 2 variant hashes (~10
    # ops each) and 3 probes; per (token, length) the recurrence (~24 ops)
    ops = Dd * Tt * (5 * 10 + 3 * 4) + Dd * Tt * L * 24
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    report.set("fused_probe", route="cuda", source="src/repro_torch/kernels/csrc/fused_probe.cu",
               replaces="src/repro/kernels/fused_probe.py:561", ms=ms, plain_ms=plain,
               bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
               library_ms=None)
    log(f"[time] fused_probe variant lanes D={Dd} T={Tt} L={L} NC={NC} G={G} bd={bd}: "
        f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {max(b_bytes, b_ops):.4f} ms "
        f"({nbytes} B, {ops} ops)")

    N, K, Lv = verify_inputs[2].shape
    ms = cuda_time_ms(lambda: jv.jaccard_verify_cuda(*verify_inputs, mode="extra"), 20)
    plain = cuda_time_ms(lambda: jv.jaccard_verify_plain(*verify_inputs, mode="extra"), 3)
    nbytes = N * K * Lv * 8 + N * Lv * 8 + N * K * 4
    # per pair: L x L int32 token compares; ~3 float32 operations per
    # entity position and 2 for the quotient. The two kinds of unit run
    # side by side, so the slower one bounds.
    int_ops, f32_ops = N * K * Lv * Lv, N * K * (3 * Lv + 2)
    ops = int_ops + f32_ops
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / FP32_OPS_PER_S) * 1e3
    report.set("jaccard_verify", route="cuda",
               source="src/repro_torch/kernels/csrc/jaccard_verify.cu",
               replaces="src/repro/kernels/jaccard_verify.py:83", ms=ms, plain_ms=plain,
               bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
               library_ms=None)
    log(f"[time] jaccard_verify N={N} K={K} L={Lv}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
        f"bound {max(b_bytes, b_ops):.4f} ms ({nbytes} B, {ops} ops); "
        "no single PyTorch call computes either kernel's function (library_ms null)")


OWN_KERNELS = ("probe_kernel", "scan_kernel", "pad_kernel", "emit_kernel", "jaccard_kernel")


def profile_execute(tag, op, prepared, docs):
    """Device time by kernel over one ``execute`` (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        op.execute(prepared, docs)
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
    log(f"[{tag}] profile of one execute: wall {wall_ms:.3f} ms, device busy {total:.3f} ms "
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
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = op.execute(prepared, docs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    for name, n in launches.items():
        if n == 0:
            fail(f"{tag}: the {name} kernel was not launched by execute")
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

    profile_execute(tag, op, prepared, docs)

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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
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
    from repro_torch.kernels import fused_probe as fp
    from repro_torch.kernels import jaccard_verify as jv

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
    _, launches_a, _ = run_phase("A", op, op_plain, prepared, docs, corpus, corpus.doc_tokens,
                                 lambda e: 0.0, (0, NUM_ENTITIES), (fp, jv))
    report.set("fused_probe", launches=launches_a["fused_probe"])
    report.set("jaccard_verify", launches=launches_a["jaccard_verify"])
    del prepared
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
    check_verify_of(report, prepared_b, docs_b, "B")
    run_phase("B", op_b, op_b_plain, prepared_b, docs_b, corpus, corpus.doc_tokens[:D_B],
              lambda e: GAMMA if e < SPLIT_B else 0.0, (0, NUM_ENTITIES), (fp, jv))

    rows = [report.rows["fused_probe"], report.rows["jaccard_verify"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
