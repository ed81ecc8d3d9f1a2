"""The port's kernels against the JAX package's Pallas kernels.

The plain PyTorch forms must equal ``fused_probe_pallas`` (bit for bit:
packed bitmap, dense signatures, tile counts, lanes and variant keys),
``fused_probe_stream_pallas``, ``window_filter_pallas`` and
``minhash_pallas`` (bit for bit) and ``jaccard_verify_pallas`` (within
1e-6), all run in interpret mode as the JAX package's own tests run
them. ``test_torch_cuda.py`` holds
the CUDA kernels against the plain forms on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.signatures import LshParams as RLshParams
from repro.core.signatures import _minhash_np
from repro.core.variants import window_variant_key
from repro.kernels import fused_probe as r_fp
from repro.kernels import ref as r_ref
from repro.kernels.jaccard_verify import jaccard_verify_pallas
from repro.kernels.minhash import minhash_pallas
from repro.kernels.window_filter import window_filter_pallas
from repro_torch.extraction.sharded import _streamed_layout
from repro_torch.kernels import fused_probe as t_fp
from repro_torch.kernels import jaccard_verify as t_jv
from repro_torch.kernels import minhash as t_mh
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import window_filter as t_wf

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def _docs(rng, D, T, vocab=2048, pad_frac=0.1):
    d = rng.integers(1, vocab, size=(D, T)).astype(np.int32)
    d[rng.random((D, T)) < pad_frac] = 0
    return d


def _bits(rng, num_bits, density=0.05):
    w = (rng.random((num_bits // 32, 32)) < density).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(axis=1).astype(np.uint32)


def _as_u32(t):
    return None if t is None else t.numpy().astype(np.uint32 if t.dtype == torch.int64 else np.int32)


def _probe_both(docs, bits, num_bits, **kw):
    ref = r_fp.fused_probe_pallas(jnp.asarray(docs), jnp.asarray(bits), num_bits, 3,
                                  interpret=True, **kw)
    got = t_fp.fused_probe_plain(torch.as_tensor(docs), torch.as_tensor(bits.view(np.int32)),
                                 num_bits, 3, **kw)
    return ref, got


def _assert_probe_equal(ref, got):
    for name, r, g in zip(("packed", "sigs", "counts", "cands", "vkeys"), ref, got):
        assert (r is None) == (g is None), name
        if r is not None:
            r = np.asarray(r)
            np.testing.assert_array_equal(_as_u32(g).astype(r.dtype), r, err_msg=name)
            assert g.shape == r.shape, name


# (sig_mode, candidates, count_only): every mode x epilogue on/off x count_only
MODES = [
    ("none", 0, False), ("none", 48, False), ("none", 48, True),
    ("lsh", 0, False), ("lsh", 48, False),
    ("variant", 0, False), ("variant", 48, False),
]


PROBE_CASES = [
    (mode, shape) for shape in (
        (5, 40, 5, 2, 0.1, True),  # ragged last tile
        (12, 96, 8, 4, 0.5, True),  # PAD-heavy
    ) for mode in MODES
] + [(mode, (3, 24, 8, 3, 0.0, False))  # validity only
     for mode in (("none", 48, False), ("lsh", 0, False), ("variant", 48, False))]


@pytest.mark.parametrize("mode,shape", PROBE_CASES)
def test_fused_probe_plain_matches_pallas(mode, shape):
    sig_mode, candidates, count_only = mode
    D, T, L, bd, pad_frac, use_filter = shape
    rng = np.random.default_rng(D * T + L)
    docs = _docs(rng, D, T, vocab=300, pad_frac=pad_frac)
    bits = _bits(rng, 1 << 12, density=0.2)
    ref, got = _probe_both(docs, bits, 1 << 12, max_len=L, sig_mode=sig_mode, bands=3,
                           rows=2, use_filter=use_filter, bd=bd, candidates=candidates,
                           count_only=count_only)
    _assert_probe_equal(ref, got)


@pytest.mark.parametrize("sig_mode", ["none", "variant"])
def test_fused_probe_zero_survivors_and_overflow(sig_mode):
    rng = np.random.default_rng(4)
    docs = _docs(rng, 6, 64, pad_frac=0.0)
    empty = np.zeros((1 << 10) // 32, np.uint32)  # nothing probes in
    full = np.full((1 << 10) // 32, 0xFFFFFFFF, np.uint32)  # everything does
    for bits, C in ((empty, 32), (full, 16)):
        ref, got = _probe_both(docs, bits, 1 << 10, max_len=6, sig_mode=sig_mode, bd=4,
                               candidates=C)
        _assert_probe_equal(ref, got)
    assert int(got[2].max()) > 16  # overflow: true counts exceed the lane


def test_fused_probe_adaptive_lane_width():
    rng = np.random.default_rng(8)
    docs = _docs(rng, 12, 64, vocab=100)
    bits = _bits(rng, 1 << 12, density=0.02)
    NC = 200
    bd = t_fp.compact_tile_height(12, 64, NC)
    counts = t_ops.fused_probe_count(torch.as_tensor(docs), (torch.as_tensor(bits.view(np.int32)),
                                     1 << 12, 3), 6, NC)
    w = t_fp.round_lane_width(int(counts.max()), NC)
    assert w < NC
    ref, got = _probe_both(docs, bits, 1 << 12, max_len=6, sig_mode="variant", bd=bd,
                           candidates=w)
    _assert_probe_equal(ref, got)
    np.testing.assert_array_equal(got[2].numpy(), counts.numpy())


@given(
    st.integers(1, 5),  # D
    st.integers(2, 12),  # T
    st.integers(1, 8),  # L, may exceed T
    st.integers(2, 9),  # vocab incl. PAD -> duplicate- and PAD-heavy
    st.integers(0, 2**31 - 1),
)
@settings(max_examples=15, deadline=None)
def test_variant_keys_property(D, T, L, vocab, seed):
    """Dense and lane variant keys equal ``window_variant_key`` at every
    (pos, len); the oracle's windows are clipped to the row end, so
    L > T stays in range."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, vocab, size=(D, T)).astype(np.int32)
    noflt = torch.zeros((8,), dtype=torch.int32)
    _, sigs, _, _, _ = t_fp.fused_probe_plain(torch.as_tensor(docs), noflt, 256, 1, L,
                                              sig_mode="variant", use_filter=False)
    sigs = _as_u32(sigs)
    for l in range(L):
        win = np.zeros((D, T, l + 1), dtype=np.int32)
        for o in range(min(l + 1, T)):
            win[:, : T - o, o] = docs[:, o:]
        k1, k2 = window_variant_key(win, win != 0, xp=np)
        np.testing.assert_array_equal(sigs[..., l, 0], k1)
        np.testing.assert_array_equal(sigs[..., l, 1], k2)
    _, _, _, cands, vkeys = t_fp.fused_probe_plain(torch.as_tensor(docs), noflt, 256, 1, L,
                                                   sig_mode="variant", use_filter=False,
                                                   candidates=16)
    cands, vkeys = cands.numpy(), _as_u32(vkeys)
    for g, j in zip(*np.nonzero(cands >= 0)):
        d, rem = divmod(int(cands[g, j]), T * L)
        p, l = divmod(rem, L)
        np.testing.assert_array_equal(vkeys[g, j], sigs[d, p, l])
    assert not vkeys[cands < 0].any()


def test_fused_probe_argument_checks():
    docs = torch.ones((2, 8), dtype=torch.int32)
    bits = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        t_fp.fused_probe_plain(docs, bits, 256, 1, 33)
    with pytest.raises(ValueError, match="count_only needs"):
        t_fp.fused_probe_plain(docs, bits, 256, 1, 4, count_only=True)
    with pytest.raises(ValueError, match="sizing pass"):
        t_fp.fused_probe_plain(docs, bits, 256, 1, 4, sig_mode="lsh", candidates=4,
                               count_only=True)
    with pytest.raises(ValueError, match="sig_mode"):
        t_fp.fused_probe_plain(docs, bits, 256, 1, 4, sig_mode="bogus")
    with pytest.raises(ValueError, match="candidates=0"):
        t_ops.fused_probe_compact(docs, None, 4, 0)
    with pytest.raises(ValueError, match="max_len=33"):
        t_ops.fused_probe_compact(docs, None, 33, 8)
    with pytest.raises(ValueError, match="lane_width=9"):
        t_ops.fused_probe_compact(docs, None, 4, 8, lane_width=9)
    with pytest.raises(ValueError, match="candidates=0"):
        t_ops.fused_probe_count(docs, None, 4, 0)


def test_ops_dispatch_on_cpu_uses_plain_form():
    rng = np.random.default_rng(0)
    docs = torch.as_tensor(_docs(rng, 4, 32))
    before = (t_fp.launches, t_jv.launches)
    packed, _ = t_ops.fused_probe(docs, None, 4)
    want, _, _, _, _ = t_fp.fused_probe_plain(docs, torch.zeros(8, dtype=torch.int32), 256, 1, 4,
                                              use_filter=False)
    assert torch.equal(packed, want)
    win = docs[:, :4].contiguous()
    ids = torch.zeros((4, 2), dtype=torch.int32)
    t_ops.jaccard_verify(win, ids, win, torch.ones(2048), "extra")
    assert (t_fp.launches, t_jv.launches) == before
    # the CUDA forms refuse CPU tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fp.fused_probe_cuda(docs, torch.zeros(8, dtype=torch.int32), 256, 1, 4)
    with pytest.raises(ValueError, match="jaccard_verify_cuda"):
        t_jv.jaccard_verify_cuda(win, torch.ones(win.shape), win[:, None], torch.ones((4, 1, 4)))


def _rand_tokens(rng, shape, vocab=512, pad_frac=0.3):
    t = rng.integers(1, vocab, size=shape).astype(np.int32)
    return np.where(rng.random(shape) < pad_frac, 0, t).astype(np.int32)


def _verify_inputs(N, K, L):
    rng = np.random.default_rng(N * 1000 + K + L)
    win = _rand_tokens(rng, (N, L))
    ent = _rand_tokens(rng, (N, K, L))
    # plant shared tokens so scores are nonzero
    ent[:, :, 0] = np.where(rng.random((N, K)) < 0.5, win[:, :1], ent[:, :, 0])
    win_w = (rng.uniform(0.1, 2.0, (N, L)) * (win != 0)).astype(np.float32)
    ent_w = (rng.uniform(0.1, 2.0, (N, K, L)) * (ent != 0)).astype(np.float32)
    return win, win_w, ent, ent_w


# the shapes of tests/test_kernels.py::test_jaccard_verify_sweep
@pytest.mark.parametrize("N,K,L", [(7, 3, 4), (128, 64, 8), (200, 130, 5), (1, 1, 2), (513, 17, 16)])
@pytest.mark.parametrize("mode", ["extra", "missing"])
def test_jaccard_verify_plain_matches_pallas(N, K, L, mode):
    args = _verify_inputs(N, K, L)
    want = jaccard_verify_pallas(*(jnp.asarray(a) for a in args), mode=mode, bn=64, bk=32,
                                 interpret=True)
    got = t_jv.jaccard_verify_plain(*(torch.as_tensor(a) for a in args), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_jaccard_verify_checks():
    win, win_w, ent, ent_w = (torch.as_tensor(a) for a in _verify_inputs(4, 3, 5))
    with pytest.raises(ValueError, match="mode"):
        t_jv.jaccard_verify_plain(win, win_w, ent, ent_w, mode="jaccard")
    with pytest.raises(ValueError, match=r"ent \[N, K, L\]"):
        t_jv.jaccard_verify_plain(win, win_w, ent[:, :, :4], ent_w, mode="extra")


# ------------------------------------------------------------ B3 streamed

# (sig_mode, count_only, use_filter, C, edit): 3 tiles of td=12 rows at
# bd=8 (td % bd != 0, so every tile carries 4 PAD rows), row base 40
STREAM_PROBE_CASES = [
    ("none", False, True, 64, None), ("variant", False, True, 64, None),
    ("none", True, True, 64, None), ("variant", True, True, 64, None),
    ("none", False, False, 64, None), ("variant", False, False, 64, None),
    ("variant", False, True, 5, None),  # lanes overflow: true counts exceed C
    ("variant", False, True, 64, "pad_tile"),  # tile 1 all PAD
    ("none", False, True, 64, "no_survivors"),  # empty filter
]


@pytest.mark.parametrize("sig_mode,count_only,use_filter,C,edit", STREAM_PROBE_CASES)
def test_fused_probe_stream_plain_matches_pallas(sig_mode, count_only, use_filter, C, edit):
    rng = np.random.default_rng(41)
    docs = _docs(rng, 36, 48, vocab=300, pad_frac=0.1)
    bits = _bits(rng, 1 << 12, density=0.2)
    if edit == "pad_tile":
        docs[12:24] = 0
    if edit == "no_survivors":
        bits[:] = 0
    sdocs, offs = _streamed_layout(torch.as_tensor(docs), 12, 3, 8)
    row_offs = offs + 40
    kw = dict(num_bits=1 << 12, num_hashes=3, max_len=6, sig_mode=sig_mode,
              use_filter=use_filter, bd=8, candidates=C, count_only=count_only)
    want = r_fp.fused_probe_stream_pallas(jnp.asarray(sdocs.numpy()), jnp.asarray(bits),
                                          jnp.asarray(row_offs), interpret=True, **kw)
    got = t_fp.fused_probe_stream_plain(sdocs, torch.as_tensor(bits.view(np.int32)),
                                        torch.as_tensor(row_offs), **kw)
    for name, r, g in zip(("counts", "cands", "vkeys"), want, got):
        assert (r is None) == (g is None), name
        if r is not None:
            np.testing.assert_array_equal(_as_u32(g).astype(np.asarray(r).dtype), np.asarray(r),
                                          err_msg=name)
    counts = got[0].numpy()
    if edit == "pad_tile":
        assert not counts[2:4].any() and counts[:2].any()
    if edit == "no_survivors":
        assert not counts.any()
    if C == 5:
        assert counts.max() > 5


def test_fused_probe_stream_equals_per_tile_probe():
    """Chunk g's lanes are the per-tile probe's lanes of the same rows,
    based at row_offs[g]."""
    rng = np.random.default_rng(42)
    docs = torch.as_tensor(_docs(rng, 16, 40, vocab=300))
    bits = torch.as_tensor(_bits(rng, 1 << 12, density=0.2).view(np.int32))
    row_offs = torch.tensor([0, 8, 100, 300], dtype=torch.int32)
    counts, cands, vkeys = t_fp.fused_probe_stream_plain(
        docs, bits, row_offs, 1 << 12, 3, 5, sig_mode="variant", bd=4, candidates=32)
    for g in range(4):
        _, _, c, x, k = t_fp.fused_probe_plain(docs[4 * g:4 * g + 4], bits, 1 << 12, 3, 5,
                                               sig_mode="variant", bd=4, candidates=32)
        assert torch.equal(counts[g:g + 1], c)
        assert vkeys.dtype == torch.int32 and torch.equal(t_fp.widen_keys(vkeys[g:g + 1]), k)
        base = int(row_offs[g]) * 40 * 5
        assert torch.equal(cands[g:g + 1], torch.where(x >= 0, x + base, -1))


@pytest.mark.parametrize("values", [[0, 1, 2**31 - 1], [2**31, 2**32 - 1, 0xDEADBEEF]])
def test_stream_key_width_round_trip(values):
    """The streamed form's int32 keys are the uint32 keys' own bits."""
    k = torch.tensor(values, dtype=torch.int64)
    narrow = t_fp.narrow_keys(k)
    assert narrow.dtype == torch.int32
    np.testing.assert_array_equal(narrow.numpy().view(np.uint32), np.array(values, np.uint32))
    assert torch.equal(t_fp.widen_keys(narrow), k)


def test_fused_probe_stream_argument_checks():
    docs = torch.ones((8, 16), dtype=torch.int32)
    bits = torch.zeros((8,), dtype=torch.int32)
    offs = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense signature"):
        t_fp.fused_probe_stream_plain(docs, bits, offs, 256, 1, 4, sig_mode="lsh", bd=4,
                                      candidates=8)
    with pytest.raises(ValueError, match="candidates > 0"):
        t_fp.fused_probe_stream_plain(docs, bits, offs, 256, 1, 4, bd=4)
    with pytest.raises(ValueError, match="multiple of bd"):
        t_fp.fused_probe_stream_plain(docs, bits, offs, 256, 1, 4, bd=3, candidates=8)
    with pytest.raises(ValueError, match="row_offs"):
        t_fp.fused_probe_stream_plain(docs, bits, offs[:1], 256, 1, 4, bd=4, candidates=8)
    with pytest.raises(ValueError, match="candidates=0"):
        t_ops.fused_probe_stream(docs, None, 4, 0, offs)
    with pytest.raises(ValueError, match="max_len=33"):
        t_ops.fused_probe_stream(docs, None, 33, 8, offs)
    with pytest.raises(ValueError, match="lane_width=9"):
        t_ops.fused_probe_stream(docs, None, 4, 8, offs, lane_width=9)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_fp.fused_probe_stream_cuda(docs, bits, offs, 256, 1, 4, bd=4, candidates=8)


# ------------------------------------------------------------ B4 window filter

# (L, D, num_bits): 3 << 12 bits is a filter whose size is not a power of two
WF_PLAIN_CASES = [pytest.param(L, D, 1 << 12, id=f"{L}-{D}") for L in (33, 40) for D in (5, 13)]
WF_PLAIN_CASES.append(pytest.param(64, 5, 3 << 12, id="64-5-nonpow2"))


@pytest.mark.parametrize("L,D,num_bits", WF_PLAIN_CASES)
def test_window_filter_plain_matches_pallas_and_ref(L, D, num_bits):
    rng = np.random.default_rng(D * L)
    docs = _docs(rng, D, 70, vocab=500, pad_frac=0.1)
    bits = _bits(rng, num_bits, density=0.3)
    want = np.asarray(window_filter_pallas(jnp.asarray(docs), jnp.asarray(bits), num_bits, 3, L,
                                           interpret=True))
    ref = np.asarray(r_ref.window_filter_ref(jnp.asarray(docs), jnp.asarray(bits), num_bits, 3,
                                             L))
    got = t_wf.window_filter_plain(torch.as_tensor(docs), torch.as_tensor(bits.view(np.int32)),
                                   num_bits, 3, L)
    assert got.dtype == torch.bool and got.shape == (D, 70, L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < got.numpy().mean() < 1  # neither all nor nothing survives


# ------------------------------------------------------------ B5 minhash

# (bands, rows, L): the CUDA kernel's shapes, above 32 row minima included
MINHASH_PLAIN_CASES = [pytest.param(4, 2, 8, id="4-2"), pytest.param(2, 4, 8, id="2-4"),
                       pytest.param(5, 7, 8, id="5-7"), pytest.param(8, 8, 8, id="8-8"),
                       pytest.param(2, 8, 40, id="2-8-L40")]


@pytest.mark.parametrize("bands,rows,L", MINHASH_PLAIN_CASES)
def test_minhash_plain_matches_pallas_and_numpy(bands, rows, L):
    rng = np.random.default_rng(bands * 10 + rows)
    toks = _docs(rng, 300, L, vocab=5000, pad_frac=0.2)
    valid = toks != 0
    valid[:7] = False  # rows with no valid token
    want = np.asarray(minhash_pallas(jnp.asarray(toks), jnp.asarray(valid), bands, rows,
                                     interpret=True))
    host = _minhash_np(toks, valid, RLshParams(bands, rows))
    got = t_mh.minhash_plain(torch.as_tensor(toks), torch.as_tensor(valid), bands, rows)
    assert got.dtype == torch.int64 and got.shape == (300, bands)
    np.testing.assert_array_equal(_as_u32(got), want)
    np.testing.assert_array_equal(_as_u32(got), host)
    np.testing.assert_array_equal(_as_u32(t_ops.minhash(torch.as_tensor(toks),
                                                        torch.as_tensor(valid), bands, rows)),
                                  want)
    assert (want[:7] == want[0]).all()  # the empty-row constant


def test_window_filter_and_minhash_checks():
    docs = torch.ones((2, 8), dtype=torch.int32)
    bits = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_wf.window_filter_cuda(docs, bits, 256, 1, 40)
    with pytest.raises(ValueError, match=r"\[D, T\]"):
        t_wf.window_filter_plain(docs[0], bits, 256, 1, 40)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_mh.minhash_cuda(docs, docs != 0, 2, 4)
    with pytest.raises(ValueError, match="valid"):
        t_mh.minhash_plain(docs, docs[:, :4] != 0, 2, 4)
    with pytest.raises(ValueError, match="bands=0"):
        t_mh.minhash_cuda(docs, docs != 0, 0, 4)
    before = (t_wf.launches, t_mh.launches)
    t_ops.window_filter(docs, bits, 256, 1, 40)
    t_ops.minhash(docs, docs != 0, 2, 4)
    assert (t_wf.launches, t_mh.launches) == before  # CPU tensors: plain forms


@pytest.mark.parametrize("bands,rows", [(5, 7), (8, 8), (65, 1)])
def test_minhash_cuda_takes_any_banding(bands, rows):
    """More than 32 row minima: refused only for lying on the CPU."""
    docs = torch.ones((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor") as err:
        t_mh.minhash_cuda(docs, docs != 0, bands, rows)
    assert "row minima" not in str(err.value)
