"""repro_torch's CUDA kernels on the card, held against their plain forms.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
kernels have no CPU mode). The file imports neither jax nor ``repro``,
so it runs on a machine with PyTorch and the CUDA toolkit alone::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cost_model import SideCost
from repro_torch.core.eejoin import EEJoinConfig, EEJoinOperator
from repro_torch.core.plan import Plan, PlanSide
from repro_torch.data.synth import make_corpus
from repro_torch.extraction import sharded
from repro_torch.kernels import fused_probe as fp
from repro_torch.kernels import jaccard_verify as jv
from repro_torch.kernels import minhash as mh
from repro_torch.kernels import ops
from repro_torch.kernels import window_filter as wf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _docs(rng, D, T, vocab=500, pad_frac=0.1):
    d = rng.integers(1, vocab, size=(D, T)).astype(np.int32)
    d[rng.random((D, T)) < pad_frac] = 0
    return d


def _bits(rng, num_bits, density):
    w = (rng.random((num_bits // 32, 32)) < density).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(axis=1).astype(np.uint32)


MODES = [
    ("none", 0, False), ("none", 48, False), ("none", 48, True),
    ("lsh", 0, False), ("lsh", 48, False),
    ("variant", 0, False), ("variant", 48, False), ("variant", 300 * 37 * 8, False),
]


@pytest.mark.parametrize("sig_mode,candidates,count_only", MODES)
@pytest.mark.parametrize("num_bits", [1 << 12, 1 << 20])  # Bloom words in shared / global memory
def test_fused_probe_cuda_matches_plain(cuda_device, sig_mode, candidates, count_only, num_bits):
    rng = np.random.default_rng(3)
    docs = torch.as_tensor(_docs(rng, 37, 300), device=cuda_device)
    bits = torch.as_tensor(_bits(rng, num_bits, 0.1).view(np.int32), device=cuda_device)
    for bd in (1, 8, 37):
        kw = dict(max_len=8, sig_mode=sig_mode, bands=4, rows=2, bd=bd, candidates=candidates,
                  count_only=count_only)
        got = fp.fused_probe_cuda(docs, bits, num_bits, 3, **kw)
        want = fp.fused_probe_plain(docs, bits, num_bits, 3, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


# (case, D, T, L, bd, bands, rows): one tile of thousands of segments;
# D % bd != 0; L = 1; L = 32 with T not a multiple of the segment;
# bands*rows = 32 (dense signatures in rounds of lengths, and an odd
# value count per window that takes 8-byte stores)
PROBE_SHAPES = [("one_tile", 512, 512, 8, 512, 4, 2), ("short_last_tile", 37, 300, 8, 8, 4, 2),
                ("L1", 16, 300, 1, 4, 4, 2), ("L32", 13, 700, 32, 4, 4, 2),
                ("bands32x1", 9, 300, 8, 4, 32, 1), ("bands4x8", 9, 300, 8, 4, 4, 8),
                ("bands1x32", 9, 300, 7, 4, 1, 32)]
# lane width against the tiles' counts and capacity cap = bd*T*L
PROBE_WIDTHS = ["cap", "zero_survivors", "below_count", "between", "above_cap"]


def _probe_both(docs, bits, num_bits, **kw):
    """Two CUDA calls in a row (the scratch is reset, the look-back does not
    race) and the plain form; all three must agree bit for bit."""
    before = fp.launches
    first = fp.fused_probe_cuda(docs, bits, num_bits, 3, **kw)
    second = fp.fused_probe_cuda(docs, bits, num_bits, 3, **kw)
    want = fp.fused_probe_plain(docs, bits, num_bits, 3, **kw)
    torch.cuda.synchronize()
    assert fp.launches == before + 2
    for a, b, w in zip(first, second, want):
        assert (a is None) == (w is None) and (b is None) == (w is None)
        if w is not None:
            assert a.dtype == w.dtype and a.shape == w.shape
            assert torch.equal(a, w) and torch.equal(b, w)
    return want


@pytest.mark.parametrize("width", PROBE_WIDTHS)
@pytest.mark.parametrize("case,D,T,L,bd,bands,rows", PROBE_SHAPES)
def test_fused_probe_cuda_edge_cases(cuda_device, case, D, T, L, bd, bands, rows, width):
    rng = np.random.default_rng(D + T + L)
    docs = torch.as_tensor(_docs(rng, D, T), device=cuda_device)
    bits = torch.as_tensor(_bits(rng, 1 << 12, 0.3).view(np.int32), device=cuda_device)
    if width == "zero_survivors":
        bits.zero_()
    cap = min(bd, D) * T * L
    counts = fp.fused_probe_plain(docs, bits, 1 << 12, 3, L, bd=bd, candidates=cap,
                                  count_only=True)[2]
    C = {"cap": cap, "zero_survivors": cap, "below_count": max(1, int(counts.min()) // 2),
         "between": int(counts.max()) + 1, "above_cap": 2 * cap}[width]
    if width == "zero_survivors":
        assert not counts.any()
    elif width == "below_count":
        assert int(counts.min()) > C
    elif width == "between":
        assert int(counts.max()) < C < cap
    for mode, cands, count_only in (("none", C, True), ("none", C, False), ("lsh", C, False),
                                    ("variant", C, False), ("variant", 0, False),
                                    ("lsh", 0, False), ("none", 0, False)):
        _probe_both(docs, bits, 1 << 12, max_len=L, sig_mode=mode, bands=bands, rows=rows,
                    bd=bd, candidates=cands, count_only=count_only)


def _verify_inputs(rng, N, K, L, device):
    win = rng.integers(0, 60, size=(N, L)).astype(np.int32)
    ent = rng.integers(0, 60, size=(N, K, L)).astype(np.int32)
    win_w = (rng.uniform(0.1, 2.0, (N, L)) * (win != 0)).astype(np.float32)
    ent_w = (rng.uniform(0.1, 2.0, (N, K, L)) * (ent != 0)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (win, win_w, ent, ent_w)]


@pytest.mark.parametrize("mode", ["extra", "missing"])
@pytest.mark.parametrize("N,K,L", [(7, 3, 4), (513, 17, 16), (4096, 9, 8), (64, 2, 32)])
def test_jaccard_verify_cuda_matches_plain(cuda_device, mode, N, K, L):
    args = _verify_inputs(np.random.default_rng(N + K + L), N, K, L, cuda_device)
    got = jv.jaccard_verify_cuda(*args, mode=mode)
    want = jv.jaccard_verify_plain(*args, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _long_verify_inputs(rng, N, K, L, device, edit):
    """Verify inputs shaped as the window_filter path gives them: each
    window real tokens then a PAD tail, entity rows with PAD inside."""
    win = rng.integers(1, 60, size=(N, L)).astype(np.int32)
    win[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=(N, 1))] = 0
    ent = rng.integers(0, 60, size=(N, K, L)).astype(np.int32)
    ent[rng.random((N, K, L)) < 0.3] = 0
    if edit == "pad_heavy":
        win[rng.random((N, L)) < 0.8] = 0
        ent[rng.random((N, K, L)) < 0.9] = 0
    if edit == "duplicates":  # every row one token repeated
        win[:] = np.where(win != 0, win[:, :1], 0)
        ent[:] = np.where(ent != 0, 7, 0)
        win[win == 0] = 7
    win_w = (rng.uniform(0.1, 2.0, (N, L)) * (win != 0)).astype(np.float32)
    ent_w = (rng.uniform(0.1, 2.0, (N, K, L)) * (ent != 0)).astype(np.float32)
    if edit == "zero_weight_windows":
        win_w[::3] = 0.0
    out = [torch.as_tensor(a, device=device) for a in (win, win_w, ent, ent_w)]
    if edit == "unaligned":  # 4 bytes past a 16-byte boundary: the 4-byte copy path
        out = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in out]
        assert all(t.data_ptr() % 16 == 4 and t.is_contiguous() for t in out)
    return out


# (N, K, edit): N*K not a multiple of the 128-pair run; K = 1; K larger
# than a run; PAD-heavy and all-duplicate rows; windows of weight 0;
# rows off 16-byte alignment
LONG_CASES = [(257, 10, None), (300, 1, None), (3, 300, None), (129, 7, "pad_heavy"),
              (64, 5, "duplicates"), (96, 3, "zero_weight_windows"), (50, 6, "unaligned")]


@pytest.mark.parametrize("mode", ["extra", "missing"])
@pytest.mark.parametrize("L", [33, 40, 64, 100])
@pytest.mark.parametrize("N,K,edit", LONG_CASES)
def test_jaccard_verify_long_rows_match_plain(cuda_device, mode, L, N, K, edit):
    args = _long_verify_inputs(np.random.default_rng(N * K + L), N, K, L, cuda_device, edit)
    before = (jv.launches, jv.long_launches)
    got = jv.jaccard_verify_cuda(*args, mode=mode)
    want = jv.jaccard_verify_plain(*args, mode=mode)
    torch.cuda.synchronize()
    assert (jv.launches, jv.long_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert (want > 0).any()


def test_ops_launch_the_kernels_on_cuda_tensors(cuda_device):
    rng = np.random.default_rng(0)
    docs = torch.as_tensor(_docs(rng, 4, 64), device=cuda_device)
    before = (fp.launches, jv.launches)
    ops.fused_probe(docs, None, 4)
    win = docs[:, :4].contiguous()
    ops.jaccard_verify(win, torch.zeros((4, 2), dtype=torch.int32, device=cuda_device), win,
                       torch.ones(500, device=cuda_device), "extra")
    assert (fp.launches, jv.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("scheme", [("index", "variant"), ("ssjoin", "lsh"), ("index", "prefix")])
def test_execute_kernel_path_equals_plain_path(cuda_device, scheme):
    c = make_corpus(num_docs=16, doc_len=128, vocab_size=1024, num_entities=200, seed=2)
    z = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    plan = Plan(0, PlanSide(*scheme), PlanSide(*scheme), "job_completion", 0.0, z, z, 0)
    out = []
    for use_kernel in (True, False):
        op = EEJoinOperator(c.dictionary, EEJoinConfig(use_kernel=use_kernel), device=cuda_device)
        m = op.execute(op.prepare(plan), c.doc_tokens)
        out.append((m.to_set(), int(m.count)))
    assert out[0] == out[1] and out[0][1] > 0


STREAM_MODES = [("none", 48, False), ("none", 48, True), ("variant", 48, False),
                ("variant", 5, False), ("variant", 300 * 37 * 8, False)]


@pytest.mark.parametrize("sig_mode,candidates,count_only", STREAM_MODES)
@pytest.mark.parametrize("num_bits", [1 << 12, 1 << 20])
def test_fused_probe_stream_cuda_matches_plain(cuda_device, sig_mode, candidates, count_only,
                                               num_bits):
    rng = np.random.default_rng(5)
    docs = torch.as_tensor(_docs(rng, 36, 300), device=cuda_device)
    docs[12:24] = 0  # a PAD-only tile
    bits = torch.as_tensor(_bits(rng, num_bits, 0.1).view(np.int32), device=cuda_device)
    for td, bd in ((12, 8), (12, 12), (12, 1)):
        sdocs, offs = sharded._streamed_layout(docs, td, 3, bd)
        row_offs = torch.as_tensor(offs + 1000, device=cuda_device)
        kw = dict(max_len=8, sig_mode=sig_mode, bd=bd, candidates=candidates,
                  count_only=count_only)
        got = fp.fused_probe_stream_cuda(sdocs, bits, row_offs, num_bits, 3, **kw)
        want = fp.fused_probe_stream_plain(sdocs, bits, row_offs, num_bits, 3, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


# (case, T, td, bd): one chunk; zero survivors; every chunk PAD; more
# survivors than lanes; rows of several segments with chunks of many
# segments and td % bd != 0
STREAM_EDGE_CASES = [("one_chunk", 300, 12, 12), ("zero_survivors", 300, 12, 8),
                     ("pad_only", 300, 12, 8), ("truncated", 300, 12, 8),
                     ("long_rows", 700, 12, 5)]


@pytest.mark.parametrize("sig_mode,count_only", [("none", True), ("none", False),
                                                 ("variant", False)])
@pytest.mark.parametrize("case,T,td,bd", STREAM_EDGE_CASES)
def test_fused_probe_stream_cuda_edge_cases(cuda_device, sig_mode, count_only, case, T, td, bd):
    rng = np.random.default_rng(7)
    docs = torch.as_tensor(_docs(rng, 24 if case != "one_chunk" else 12, T),
                           device=cuda_device)
    bits = torch.as_tensor(_bits(rng, 1 << 12, 0.3).view(np.int32), device=cuda_device)
    if case == "zero_survivors":
        bits.zero_()
    if case == "pad_only":
        docs.zero_()
    sdocs, offs = sharded._streamed_layout(docs, td, docs.shape[0] // td, bd)
    if case == "one_chunk":
        assert len(offs) == 1
    row_offs = torch.as_tensor(offs + 24, device=cuda_device)
    C = 40 if case == "truncated" else sdocs.shape[0] * T * 8
    kw = dict(max_len=8, sig_mode=sig_mode, bd=bd, candidates=C, count_only=count_only)
    got = fp.fused_probe_stream_cuda(sdocs, bits, row_offs, 1 << 12, 3, **kw)
    want = fp.fused_probe_stream_plain(sdocs, bits, row_offs, 1 << 12, 3, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    counts = got[0]
    if case in ("zero_survivors", "pad_only"):
        assert not counts.any()
    elif case == "truncated":
        assert int(counts.max()) > C
    else:
        assert counts.all()


def _window_filter_both(rng, D, T, L, num_bits, density=0.1):
    docs = torch.as_tensor(_docs(rng, D, T), device="cuda")
    bits = torch.as_tensor(_bits(rng, num_bits, density).view(np.int32), device="cuda")
    got = wf.window_filter_cuda(docs, bits, num_bits, 3, L)
    want = wf.window_filter_plain(docs, bits, num_bits, 3, L)
    torch.cuda.synchronize()
    return got, want


# num_bits: Bloom words in shared memory (4 KiB, and 98,304 bits, not a
# power of two) or read through the cache (128 KiB, above the 96 KiB the
# filter may take in shared memory)
@pytest.mark.parametrize("L", [33, 40, 8, 64, 100])
@pytest.mark.parametrize("num_bits", [1 << 12, 1 << 20, 3 << 15])
def test_window_filter_cuda_matches_plain(cuda_device, L, num_bits):
    got, want = _window_filter_both(np.random.default_rng(L), 13, 600, L, num_bits)
    assert got.dtype == torch.bool and torch.equal(got, want)


# (D, T, L): one document; T < L; T not a multiple of the 32- or
# 128-position run and T*L not a multiple of 16; batches large enough for
# the persistent blocks (more than 132*4 runs of 32 positions); L long
# enough that a run's hit words take two batches of loads (L = 150, 300)
WF_EDGE_SHAPES = [(1, 600, 40), (3, 20, 40), (2, 129, 33), (1, 1, 8), (5, 7, 100),
                  (2, 400, 300), (1024, 100, 40), (300, 700, 64), (600, 515, 37),
                  (700, 130, 150)]


@pytest.mark.parametrize("num_bits", [1 << 12, 1 << 20, 5 << 17])  # 5 << 17: 80 KiB, shared
@pytest.mark.parametrize("D,T,L", WF_EDGE_SHAPES)
def test_window_filter_cuda_edge_shapes(cuda_device, D, T, L, num_bits):
    got, want = _window_filter_both(np.random.default_rng(D * T + L), D, T, L, num_bits, 0.3)
    assert torch.equal(got, want)


def _minhash_inputs(rng, N, L, misaligned=False):
    toks = _docs(rng, N, L, vocab=60000, pad_frac=0.3)
    valid = toks != 0
    valid[: min(3, N)] = False  # rows with no valid token
    toks, valid = torch.as_tensor(toks, device="cuda"), torch.as_tensor(valid, device="cuda")
    if misaligned:  # views 4 bytes and 1 byte into their storage: not 16-byte aligned
        t2 = torch.zeros(N * L + 1, dtype=torch.int32, device="cuda")
        t2[1:] = toks.flatten()
        v2 = torch.zeros(N * L + 1, dtype=torch.bool, device="cuda")
        v2[1:] = valid.flatten()
        toks, valid = t2[1:].view(N, L), v2[1:].view(N, L)
    return toks, valid


# bands x rows up to 8 x 8 (two chunks of 32 row minima) and 65 x 1 (65
# bands: signatures not staged), at every row length instance
@pytest.mark.parametrize("L", [8, 40, 1, 7, 9, 64])
@pytest.mark.parametrize("bands,rows", [(4, 2), (2, 4), (1, 8), (4, 8), (2, 8), (5, 7), (8, 8),
                                        (65, 1)])
def test_minhash_cuda_matches_plain(cuda_device, bands, rows, L):
    toks, valid = _minhash_inputs(np.random.default_rng(bands * rows + L), 5000, L)
    got = mh.minhash_cuda(toks, valid, bands, rows)
    want = mh.minhash_plain(toks, valid, bands, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[:3] == got[0]).all()


# N: one row, partial tiles of 128 rows, and tiles walked by persistent
# blocks; L = 100 stages rows in column chunks; misaligned views stage
# with plain loads
@pytest.mark.parametrize("N", [1, 255, 257, 5000, 70_000])
@pytest.mark.parametrize("L,bands,rows,misaligned", [(8, 4, 2, False), (40, 2, 8, False),
                                                     (100, 5, 7, False), (8, 4, 2, True),
                                                     (40, 8, 8, True)])
def test_minhash_cuda_tiles(cuda_device, N, L, bands, rows, misaligned):
    toks, valid = _minhash_inputs(np.random.default_rng(N + L), N, L, misaligned)
    assert (toks.data_ptr() % 16 != 0) == misaligned
    got = mh.minhash_cuda(toks, valid, bands, rows)
    want = mh.minhash_plain(toks, valid, bands, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ops_launch_the_new_kernels_on_cuda_tensors(cuda_device):
    rng = np.random.default_rng(1)
    docs = torch.as_tensor(_docs(rng, 8, 64), device=cuda_device)
    bits = torch.as_tensor(_bits(rng, 1 << 12, 0.1).view(np.int32), device=cuda_device)
    before = (fp.stream_launches, wf.launches, mh.launches)
    ops.fused_probe_stream(docs, (bits, 1 << 12, 3), 4, 64,
                           torch.zeros((2,), dtype=torch.int32, device=cuda_device), bd=4)
    ops.window_filter(docs, bits, 1 << 12, 3, 40)
    ops.minhash(docs, docs != 0, 2, 4)
    assert (fp.stream_launches, wf.launches, mh.launches) == tuple(b + 1 for b in before)


@pytest.mark.parametrize("scheme", [("index", "variant"), ("ssjoin", "lsh")])
def test_streaming_paths_equal_execute(cuda_device, tmp_path, scheme):
    """execute_sharded and execute_corpus (pinned staging over several
    shards, a kill and a resume) give execute's matches on the card."""
    c = make_corpus(num_docs=24, doc_len=128, vocab_size=1024, num_entities=200, seed=2)
    z = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    plan = Plan(0, PlanSide(*scheme), PlanSide(*scheme), "job_completion", 0.0, z, z, 0)
    op = EEJoinOperator(c.dictionary, EEJoinConfig(use_kernel=True, max_candidates=24 * 128 * 5,
                                                   device_budget_bytes=4 * 128 * 4 * 2),
                        device=cuda_device)
    prep = op.prepare(plan)
    want = op.execute(prep, c.doc_tokens).to_set()
    assert want
    before = fp.stream_launches
    assert op.execute_sharded(prep, c.doc_tokens, shard_docs=8, tile_docs=3).to_set() == want
    corpus = sharded.MemmapCorpus.write(str(tmp_path / "corpus"), c.doc_tokens)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="simulated interruption"):
        op.execute_corpus(prep, corpus, tile_docs=2, checkpoint_dir=ckpt, fail_after_shards=3)
    assert op.execute_corpus(prep, corpus, tile_docs=2, checkpoint_dir=ckpt).to_set() == want
    assert op.execute_corpus(prep, corpus, tile_docs=2).to_set() == want
    assert fp.stream_launches > before


def test_execute_long_entities_kernel_path_equals_plain(cuda_device):
    c = make_corpus(num_docs=8, doc_len=128, vocab_size=1024, num_entities=100,
                    min_entity_len=2, max_entity_len=40, seed=3)
    z = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    plan = Plan(0, PlanSide("index", "prefix"), PlanSide("index", "prefix"), "job_completion",
                0.0, z, z, 0)
    out = []
    before = wf.launches
    for use_kernel in (True, False):
        op = EEJoinOperator(c.dictionary, EEJoinConfig(use_kernel=use_kernel,
                                                       max_candidates=8 * 128 * 40),
                            device=cuda_device)
        m = op.execute(op.prepare(plan), c.doc_tokens)
        out.append((m.to_set(), int(m.count)))
    assert out[0] == out[1] and out[0][1] > 0
    assert wf.launches == before + 1
