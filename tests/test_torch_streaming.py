"""repro_torch's streaming paths against the JAX package.

``stream_filter_compact``, ``sharded_filter_compact(mesh=None)`` and
``spill_filter_compact`` must give the reference's candidate dict field
for field (uneven shards, ``td % bd != 0`` tiles, adaptive lanes,
variant keys), with the reference's ``stream_stats`` counters; lane
checkpoints and manifests must be interchangeable both ways; and
``execute_corpus`` / ``execute_sharded`` must give ``execute``'s and the
reference's match sets. The reference's streamed probe runs in
interpret mode, as ``tests/test_streaming.py`` runs it; the port runs
on the CPU, so its kernels run as their plain PyTorch forms.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.cost_model import OBJ_JOB, SideCost
from repro.core.eejoin import EEJoinConfig as RConfig
from repro.core.eejoin import EEJoinOperator as ROperator
from repro.core.plan import Plan as RPlan
from repro.core.plan import PlanSide as RPlanSide
from repro.extraction import engine as r_eng
from repro.extraction import sharded as r_sh
from repro_torch.core import plan as t_plan
from repro_torch.core.cost_model import SideCost as TSideCost
from repro_torch.core.eejoin import EEJoinConfig as TConfig
from repro_torch.core.eejoin import EEJoinOperator as TOperator
from repro_torch.extraction import engine as t_eng
from repro_torch.extraction import sharded as t_sh

GAMMA = 0.8
CPU = torch.device("cpu")


def _docs(rng, D, T, vocab=2048, pad_frac=0.15):
    d = rng.integers(1, vocab, size=(D, T)).astype(np.int32)
    d[rng.random((D, T)) < pad_frac] = 0
    return d


def _filter(rng, num_bits=1 << 14, density=0.3):
    w = (rng.random((num_bits // 32, 32)) < density).astype(np.uint32)
    bits = (w << np.arange(32, dtype=np.uint32)).sum(axis=1).astype(np.uint32)
    return ((jnp.asarray(bits), num_bits, 3),
            (torch.as_tensor(bits.view(np.int32)), num_bits, 3))


def _params(**kw):
    kw = dict(dict(gamma=GAMMA, scheme="prefix", use_kernel=True), **kw)
    return r_eng.ExtractParams(**kw), t_eng.ExtractParams(**kw)


def _assert_cands_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "variant_keys":
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))
            continue
        w = np.asarray(want[k])
        g = got[k].numpy()
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
        assert g.shape == w.shape, k


# ---------------------------------------------------- single-device streaming

# (scheme, streamed, adaptive, D, T, tile_docs, NC): D=13 with tile 3 gives
# a ragged PAD tail; tile 12 at NC=64, T=64 gives bd=8, so td % bd != 0
STREAM_CASES = [
    (scheme, streamed, False, 13, 96, 3, 256)
    for scheme in ("word", "lsh", "variant") for streamed in (True, False)
] + [
    ("prefix", True, False, 30, 64, 12, 64),
    ("variant", True, False, 30, 64, 12, 64),
    ("prefix", True, True, 13, 96, 3, 256),
    ("variant", True, True, 30, 64, 12, 512),
]


@pytest.mark.parametrize("scheme,streamed,adaptive,D,T,tile_docs,NC", STREAM_CASES)
def test_stream_filter_compact_matches_reference(scheme, streamed, adaptive, D, T, tile_docs,
                                                 NC):
    rng = np.random.default_rng(D + tile_docs + NC)
    docs = _docs(rng, D, T)
    rflt, tflt = _filter(rng)
    rp, tp = _params(scheme=scheme, max_candidates=NC, streamed=streamed,
                     adaptive_lanes=adaptive)
    want = r_sh.stream_filter_compact(jnp.asarray(docs), 7, rflt, rp, tile_docs=tile_docs)
    got = t_sh.stream_filter_compact(torch.as_tensor(docs), 7, tflt, tp, tile_docs=tile_docs)
    _assert_cands_equal(got, want)
    assert int(want["n_survive"]) > 0
    # and the single-call front end of the port
    single = t_eng.fused_filter_compact(torch.as_tensor(docs), 7, tflt,
                                        t_eng.ExtractParams(gamma=GAMMA, scheme=scheme,
                                                            use_kernel=True, max_candidates=NC))
    for k in ("win_tokens", "doc", "pos", "length", "n_survive", "overflow"):
        assert torch.equal(got[k], single[k]), k


def test_streamed_layout_replays_per_tile_padding():
    docs = torch.arange(1, 2 * 12 * 4 + 1, dtype=torch.int32).reshape(24, 4)
    out, offs = t_sh._streamed_layout(docs, 12, 2, 8)
    rout, roffs = r_sh._streamed_layout(jnp.asarray(docs.numpy()), 12, 2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(offs, roffs)
    assert offs.tolist() == [0, 8, 12, 20]  # unpadded row numbering
    assert out.shape == (32, 4) and not out[12:16].any() and not out[28:].any()


@pytest.mark.parametrize("case", ["pad_only_tiles", "zero_survivors"])
def test_stream_probe_tiles_edge_cases(case):
    rng = np.random.default_rng(23)
    docs = _docs(rng, 16, 64, pad_frac=0.0 if case == "zero_survivors" else 0.15)
    rflt, tflt = _filter(rng)
    if case == "pad_only_tiles":
        docs[4:12] = 0  # tiles 1 and 2 of tile_docs=4
    else:
        rflt = (jnp.zeros_like(rflt[0]), *rflt[1:])
        tflt = (torch.zeros_like(tflt[0]), *tflt[1:])
    rp, tp = _params(max_candidates=128, streamed=True)
    want = r_sh.stream_probe_tiles(jnp.asarray(docs), 6, rflt, rp, tile_docs=4)
    got = t_sh.stream_probe_tiles(torch.as_tensor(docs), 6, tflt, tp, tile_docs=4)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = got[0].numpy().reshape(4, -1).sum(axis=1)
    if case == "pad_only_tiles":
        assert counts[1] == counts[2] == 0 < counts[0]
    else:
        assert not counts.any() and (got[1].numpy() == -1).all()


@pytest.mark.parametrize("lane_width", [None, 16])
def test_stream_probe_tiles_variant_keys(lane_width):
    """Streamed and per-tile lanes carry the reference's variant keys,
    as int32 bit patterns in both launch modes."""
    rng = np.random.default_rng(27)
    docs = _docs(rng, 14, 48)
    rflt, tflt = _filter(rng)
    want = None
    for streamed in (True, False):
        rp, tp = _params(scheme="variant", max_candidates=256, streamed=streamed)
        ref = r_sh.stream_probe_tiles(jnp.asarray(docs), 5, rflt, rp, tile_docs=4,
                                      lane_width=lane_width, sig_mode="variant")
        got = t_sh.stream_probe_tiles(torch.as_tensor(docs), 5, tflt, tp, tile_docs=4,
                                      lane_width=lane_width, sig_mode="variant")
        assert got[2].dtype == torch.int32
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy().astype(np.asarray(r).dtype), np.asarray(r))
        if want is None:
            want = got
        else:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_stream_tile_counts_match_reference():
    rng = np.random.default_rng(25)
    docs = _docs(rng, 13, 96)
    rflt, tflt = _filter(rng)
    for streamed in (True, False):
        rp, tp = _params(max_candidates=128, streamed=streamed)
        want = r_sh.stream_tile_counts(jnp.asarray(docs), 7, rflt, rp, tile_docs=3)
        got = t_sh.stream_tile_counts(torch.as_tensor(docs), 7, tflt, tp, tile_docs=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_streamed_and_lsh_force():
    _, tp = _params()
    assert t_sh.resolve_streamed(tp, 1) is False and t_sh.resolve_streamed(tp, 2) is True
    _, on = _params(streamed=True)
    _, off = _params(streamed=False)
    assert t_sh.resolve_streamed(on, 1) is True and t_sh.resolve_streamed(off, 8) is False
    _, forced = _params(scheme="lsh", kernel_sigs=True)
    with pytest.raises(ValueError, match="kernel_sigs=True"):
        t_sh.stream_filter_compact(torch.ones((4, 16), dtype=torch.int32), 4, None, forced)


# -------------------------------------------------------- geometry helpers

@pytest.mark.parametrize("total,workers,shard,tile", [
    (13, 1, None, None), (13, 4, None, None), (13, 1, 4, 3), (5, 1, 64, 64), (1024, 1, 256, 64),
    (7, 3, 100, 2),
])
def test_plan_shards_matches_reference(total, workers, shard, tile):
    got = t_sh.plan_shards(total, workers, shard, tile)
    want = r_sh.plan_shards(total, workers, shard, tile)
    assert (got.total_docs, got.shard_docs, got.num_shards, got.tile_docs,
            got.tiles_per_shard) == (want.total_docs, want.shard_docs, want.num_shards,
                                     want.tile_docs, want.tiles_per_shard)


@pytest.mark.parametrize("total,seq,budget,tile", [
    (1024, 512, 1 << 20, None), (1024, 512, 1 << 10, None), (32, 64, 4 * 64 * 4 * 2, 2),
    (10, 64, 1 << 30, 4), (1000, 100, 777_777, 7),
])
def test_shard_docs_for_budget_matches_reference(total, seq, budget, tile):
    assert t_sh.shard_docs_for_budget(total, seq, budget, tile) == \
        r_sh.shard_docs_for_budget(total, seq, budget, tile)


def test_phase_c_geometry():
    """1,024 x 512 docs under a 1 MiB budget: 4 shards of 4 64-doc tiles."""
    sd = t_sh.shard_docs_for_budget(1024, 512, 1 << 20)
    spec = t_sh.plan_shards(1024, 1, sd, None)
    assert (spec.shard_docs, spec.num_shards, spec.tile_docs, spec.tiles_per_shard) == \
        (256, 4, 64, 4)


# ------------------------------------------------------ sharded / spill

SHARD_CASES = [
    ("prefix", False, 4, 2, 256),  # 13 docs: an uneven last shard
    ("variant", False, 5, 2, 256),
    ("variant", True, 6, 3, 256),
    ("prefix", True, 13, 4, 96),
]


@pytest.mark.parametrize("scheme,adaptive,shard_docs,tile_docs,NC", SHARD_CASES)
def test_sharded_and_spill_match_reference(tmp_path, scheme, adaptive, shard_docs, tile_docs,
                                           NC):
    rng = np.random.default_rng(31 + shard_docs)
    docs = _docs(rng, 13, 96)
    rflt, tflt = _filter(rng)
    rp, tp = _params(scheme=scheme, max_candidates=NC, adaptive_lanes=adaptive)
    rs, ts = {}, {}
    want = r_sh.sharded_filter_compact(jnp.asarray(docs), 7, rflt, rp, shard_docs=shard_docs,
                                       tile_docs=tile_docs, stream_stats=rs)
    got = t_sh.sharded_filter_compact(torch.as_tensor(docs), 7, tflt, tp,
                                      shard_docs=shard_docs, tile_docs=tile_docs,
                                      stream_stats=ts)
    _assert_cands_equal(got, want)
    assert ts == rs
    corpus = t_sh.MemmapCorpus.write(str(tmp_path / "corpus"), docs)
    ts2 = {}
    spill = t_sh.spill_filter_compact(corpus, 7, tflt, tp, shard_docs=shard_docs,
                                      tile_docs=tile_docs, stream_stats=ts2)
    _assert_cands_equal(spill, want)
    assert ts2 == dict(ts, spill_bytes_staged=-(-13 // shard_docs) * shard_docs * 96 * 4)


def test_sharded_mesh_is_not_ported():
    _, tp = _params()
    with pytest.raises(NotImplementedError, match="A6"):
        t_sh.sharded_filter_compact(torch.ones((4, 16), dtype=torch.int32), 4, None, tp,
                                    mesh=object())


def test_spill_over_budget_and_host_arrays(tmp_path):
    rng = np.random.default_rng(35)
    docs = _docs(rng, 32, 64)
    rflt, tflt = _filter(rng)
    rp, tp = _params(max_candidates=256)
    want = r_eng.fused_filter_compact(jnp.asarray(docs), 6, rflt, rp)
    budget = 4 * 64 * 4 * 2  # 4 docs of double-buffered staging: 8 shards
    stats = {}
    got = t_sh.spill_filter_compact(docs, 6, tflt, tp, device_budget_bytes=budget,
                                    tile_docs=2, stream_stats=stats)
    _assert_cands_equal(got, want)
    assert stats["spill_bytes_staged"] == 8 * 4 * 64 * 4
    assert stats["streamed_launches"] == 8
    assert stats["tiles_streamed"] == stats["dma_waits"] > 8
    with pytest.raises(ValueError, match="epilogue"):
        t_sh.spill_filter_compact(docs, 33, tflt, tp)


def test_memmap_corpus_files_interchange(tmp_path):
    docs = _docs(np.random.default_rng(36), 5, 7)
    t_sh.MemmapCorpus.write(str(tmp_path / "t"), torch.as_tensor(docs))
    r_sh.MemmapCorpus.write(str(tmp_path / "r"), docs)
    for a, b in (("t", "r"), ("r", "t")):
        assert (tmp_path / f"{a}.bin").read_bytes() == (tmp_path / f"{b}.bin").read_bytes()
        assert json.loads((tmp_path / f"{a}.json").read_text()) == \
            json.loads((tmp_path / f"{b}.json").read_text())
    np.testing.assert_array_equal(t_sh.MemmapCorpus.open(str(tmp_path / "r")).tokens, docs)


# ------------------------------------------------------ checkpoints

@pytest.mark.parametrize("scheme", ["prefix", "variant"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_kill_and_resume_across_packages(tmp_path, scheme, writer):
    """A job killed in one package resumes in the other to equal candidates."""
    rng = np.random.default_rng(32)
    docs = _docs(rng, 24, 64)
    rflt, tflt = _filter(rng)
    rp, tp = _params(scheme=scheme, max_candidates=256)
    corpus = t_sh.MemmapCorpus.write(str(tmp_path / "corpus"), docs)
    rcorpus = r_sh.MemmapCorpus.open(str(tmp_path / "corpus"))
    ckpt = str(tmp_path / "lanes")
    want = r_eng.fused_filter_compact(jnp.asarray(docs), 6, rflt, rp)
    kill, resume = ((r_sh.spill_filter_compact, rcorpus, rflt, rp),
                    (t_sh.spill_filter_compact, corpus, tflt, tp))
    if writer == "port":
        kill, resume = resume, kill
    fn, c, f, p = kill
    with pytest.raises(RuntimeError, match="simulated interruption"):
        fn(c, 6, f, p, shard_docs=4, tile_docs=2, checkpoint_dir=ckpt, fail_after_shards=2)
    done = sorted(x.name for x in (tmp_path / "lanes").glob("shard_*.npz"))
    assert done == ["shard_000000.npz", "shard_000001.npz"]
    with np.load(tmp_path / "lanes" / done[0]) as z:
        assert z["lane"].dtype == np.int32 and z["count"].dtype == np.int32
        if scheme == "variant":
            assert z["keys"].dtype == np.uint32
    fn, c, f, p = resume
    stats = {}
    got = fn(c, 6, f, p, shard_docs=4, tile_docs=2, checkpoint_dir=ckpt, stream_stats=stats)
    if writer == "port":  # the reference resumed: hold its dict as the port's
        got = {k: (tuple(torch.as_tensor(np.array(a, np.int64)) for a in v)
                   if k == "variant_keys" else torch.as_tensor(np.array(v)))
               for k, v in got.items()}
    _assert_cands_equal(got, want)
    assert stats["checkpoint_hits"] == 2 and stats["checkpoint_writes"] == 4


def test_manifest_equals_reference_and_guards_resume(tmp_path):
    rng = np.random.default_rng(34)
    docs = _docs(rng, 12, 64)
    rflt, tflt = _filter(rng)
    rp, tp = _params(scheme="variant", max_candidates=128, adaptive_lanes=True)
    spec_r, spec_t = r_sh.plan_shards(12, 1, 4, 2), t_sh.plan_shards(12, 1, 4, 2)
    assert t_sh.job_manifest(spec_t, 64, 6, tp, tflt, "variant") == \
        r_sh.job_manifest(spec_r, 64, 6, rp, rflt, "variant")
    ckpt = str(tmp_path / "lanes")
    _, tp = _params(max_candidates=128)
    t_sh.sharded_filter_compact(torch.as_tensor(docs), 6, tflt, tp, shard_docs=4, tile_docs=2,
                                checkpoint_dir=ckpt)
    _, other = _filter(np.random.default_rng(99))
    with pytest.raises(ValueError, match="manifest mismatch"):
        t_sh.sharded_filter_compact(torch.as_tensor(docs), 6, other, tp, shard_docs=4,
                                    tile_docs=2, checkpoint_dir=ckpt)
    with pytest.raises(ValueError, match="manifest mismatch"):
        t_sh.sharded_filter_compact(torch.as_tensor(docs), 6, tflt, tp, shard_docs=6,
                                    tile_docs=2, checkpoint_dir=ckpt)
    got = t_sh.spill_filter_compact(docs, 6, other, tp, shard_docs=4, tile_docs=2,
                                    checkpoint_dir=ckpt, reset_checkpoints=True)
    want = t_eng.fused_filter_compact(torch.as_tensor(docs), 6, other, tp)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------ end to end

def _plans(head, tail):
    rz = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    tz = TSideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    return (RPlan(0, RPlanSide(*head), RPlanSide(*tail), OBJ_JOB, 0.0, rz, rz, 0),
            t_plan.Plan(0, t_plan.PlanSide(*head), t_plan.PlanSide(*tail), OBJ_JOB, 0.0,
                        tz, tz, 0))


@pytest.mark.parametrize("scheme", [("index", "prefix"), ("ssjoin", "variant"),
                                    ("ssjoin", "lsh")])
def test_execute_corpus_and_sharded_match_execute_and_reference(small_corpus, tmp_path,
                                                                scheme):
    c = small_corpus
    T = c.doc_tokens.shape[1]
    cfg = dict(gamma=GAMMA, max_candidates=4096, result_capacity=8192, use_kernel=True,
               device_budget_bytes=3 * T * 4 * 2)
    rplan, tplan = _plans(scheme, scheme)
    rop = ROperator(c.dictionary, RConfig(**cfg))
    want = rop.execute(rop.prepare(rplan), jnp.asarray(c.doc_tokens)).to_set()
    assert want

    top = TOperator(c.dictionary, TConfig(**cfg), device=CPU)
    prep = top.prepare(tplan)
    assert top.execute(prep, c.doc_tokens).to_set() == want
    assert top.execute_sharded(prep, c.doc_tokens, shard_docs=3, tile_docs=2).to_set() == want
    corpus = t_sh.MemmapCorpus.write(str(tmp_path / "corpus"), c.doc_tokens)
    ckpt = str(tmp_path / "ckpt")
    stats = {}
    # the budget gives shards of 3 docs, each 3 tiles of 1: streamed
    with pytest.raises(RuntimeError, match="simulated interruption"):
        top.execute_corpus(prep, corpus, tile_docs=1, checkpoint_dir=ckpt,
                           fail_after_shards=1)
    got = top.execute_corpus(prep, corpus, tile_docs=1, checkpoint_dir=ckpt,
                             stream_stats=stats)
    assert got.to_set() == want
    assert stats["checkpoint_hits"] == 1 and stats["streamed_launches"] == 2


def test_streaming_entry_points_need_use_kernel(small_corpus):
    top = TOperator(small_corpus.dictionary, TConfig(use_kernel=False), device=CPU)
    prep = top.prepare(_plans(("index", "prefix"), ("index", "prefix"))[1])
    with pytest.raises(ValueError, match="use_kernel=True"):
        top.execute_sharded(prep, small_corpus.doc_tokens)
    with pytest.raises(ValueError, match="use_kernel=True"):
        top.execute_corpus(prep, small_corpus.doc_tokens)
