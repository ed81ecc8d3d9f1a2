"""repro_torch hashing and host builds against the JAX package, bit for bit.

Inputs are made with numpy from fixed seeds and fed to both packages:
every hash family on random and edge uint32 values, the Bloom words,
entity signatures of every scheme, variant keys, window keys over
random, PAD-heavy and all-duplicate windows, both index kinds and the
synthetic corpus.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import filter as r_filter
from repro.core import hashing as r_hashing
from repro.core import index as r_index
from repro.core import semantics as r_sem
from repro.core import signatures as r_sig
from repro.core import variants as r_var
from repro.data.synth import make_corpus as r_make_corpus
from repro.kernels import _hashing as r_khash
from repro.kernels import fused_probe as r_fp
from repro_torch.core import filter as t_filter
from repro_torch.core import hashing as t_hashing
from repro_torch.core import index as t_index
from repro_torch.core import semantics as t_sem
from repro_torch.core import signatures as t_sig
from repro_torch.core import variants as t_var
from repro_torch.data.synth import make_corpus as t_make_corpus
from repro_torch.kernels import _hashing as t_khash
from repro_torch.kernels import fused_probe as t_fp

EDGE = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF,
     0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 65535, 65536],
    dtype=np.uint32,
)


def _u32_values(seed, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)])


def _t(x):
    """uint32 numpy -> int64-carried torch tensor."""
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def corpus():
    return r_make_corpus(num_docs=6, doc_len=48, vocab_size=256, num_entities=40,
                         max_entity_len=6, seed=5)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_hash_u32_hash2_mix_bit_identical(seed):
    x = _u32_values(seed)
    want = r_hashing.hash_u32(x, seed=seed, xp=np)
    np.testing.assert_array_equal(t_hashing.hash_u32(x, seed=seed), want)
    np.testing.assert_array_equal(_np(t_hashing.hash_u32(_t(x), seed=seed)), want)
    np.testing.assert_array_equal(
        _np(t_hashing.hash_u32(torch.as_tensor(x.view(np.int32)), seed=seed)), want)
    for got, ref in zip(t_hashing.hash2(_t(x), seed), r_hashing.hash2(x, seed, xp=np)):
        np.testing.assert_array_equal(_np(got), ref)
    ref_mix = np.asarray(r_khash.mix(jnp.asarray(x)))
    np.testing.assert_array_equal(_np(t_khash.mix(_t(x))), ref_mix)
    np.testing.assert_array_equal(_np(t_hashing.mix(_t(x))), ref_mix)
    np.testing.assert_array_equal(t_hashing.mix(x), ref_mix)
    np.testing.assert_array_equal(
        _np(t_khash.hash_seeded(_t(x), seed)),
        np.asarray(r_khash.hash_seeded(jnp.asarray(x), seed)))
    np.testing.assert_array_equal(
        t_hashing.hash_u32(_t(x), seed).to(torch.uint32).numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_combine_bit_identical(seed):
    h = _u32_values(seed)
    g = np.roll(_u32_values(seed + 100), 3)
    want = r_hashing.combine(h, g, xp=np)
    np.testing.assert_array_equal(t_hashing.combine(h, g), want)
    np.testing.assert_array_equal(_np(t_hashing.combine(_t(h), _t(g))), want)
    np.testing.assert_array_equal(
        _np(t_khash.combine(_t(h), _t(g))),
        np.asarray(r_khash.combine(jnp.asarray(h), jnp.asarray(g))))


def _windows(kind, rng, shape=(64, 7)):
    if kind == "random":
        return rng.integers(0, 1000, size=shape).astype(np.int32)
    if kind == "pad_heavy":
        w = rng.integers(1, 1000, size=shape).astype(np.int32)
        w[rng.random(shape) < 0.7] = 0
        return w
    if kind == "all_duplicate":
        return np.repeat(rng.integers(1, 1000, size=(shape[0], 1)), shape[1], axis=1).astype(np.int32)
    if kind == "tiny_vocab":
        return rng.integers(0, 3, size=shape).astype(np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "pad_heavy", "all_duplicate", "tiny_vocab"])
def test_set_hash_and_window_variant_key(kind):
    rng = np.random.default_rng(len(kind))
    win = _windows(kind, rng)
    valid = win != 0
    for seed in (0, 101, 202):
        want = r_hashing.set_hash(win, valid, seed=seed, xp=np)
        np.testing.assert_array_equal(t_hashing.set_hash(win, valid, seed=seed), want)
        np.testing.assert_array_equal(
            _np(t_hashing.set_hash(torch.as_tensor(win), torch.as_tensor(valid), seed=seed)), want)
    want = r_var.window_variant_key(win, valid, xp=np)
    got = t_var.window_variant_key(torch.as_tensor(win), torch.as_tensor(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), w)
    fo = r_sem.first_occurrence_mask(win, xp=np)
    np.testing.assert_array_equal(t_sem.first_occurrence_mask(torch.as_tensor(win)).numpy(), fo)
    np.testing.assert_array_equal(t_sem.first_occurrence_mask(win), fo)
    np.testing.assert_array_equal(t_fp.streaming_first_occurrence(torch.as_tensor(win)).numpy(), fo)
    np.testing.assert_array_equal(t_fp.streaming_first_occurrence(win), fo)


@pytest.mark.parametrize("kind", ["random", "pad_heavy", "all_duplicate"])
@pytest.mark.parametrize("scheme", r_sig.SIG_NAMES)
def test_window_signatures_bit_identical(kind, scheme):
    rng = np.random.default_rng(11)
    win = _windows(kind, rng, shape=(40, 6))
    lsh = r_sig.LshParams(bands=3, rows=2)
    ws, wm = r_sig.window_signatures(scheme, jnp.asarray(win), jnp.asarray(win != 0), 0.8, lsh)
    ts, tm = t_sig.window_signatures(scheme, torch.as_tensor(win), torch.as_tensor(win != 0), 0.8,
                                     t_sig.LshParams(bands=3, rows=2))
    np.testing.assert_array_equal(_np(ts), np.asarray(ws))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("sim", r_sem.SIM_NAMES)
def test_similarity_matches_reference(sim):
    rng = np.random.default_rng(2)
    ent = _windows("pad_heavy", rng, shape=(30, 5, 6))
    win = _windows("tiny_vocab", rng, shape=(30, 1, 6)) * 97
    tw = rng.uniform(0.1, 2.0, size=1000).astype(np.float32)
    tw[0] = 0
    want = r_sem.similarity(sim, jnp.asarray(ent), jnp.asarray(win), jnp.asarray(tw), xp=jnp)
    got = t_sem.similarity(sim, torch.as_tensor(ent), torch.as_tensor(win), torch.as_tensor(tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_empty_band_sigs(bands=5, rows=3):
    np.testing.assert_array_equal(t_fp.empty_band_sigs(bands, rows),
                                  r_fp.empty_band_sigs(bands, rows))


@pytest.mark.parametrize("gamma", [0.5, 0.8, 1.0])
def test_bloom_words_array_equal(corpus, gamma):
    d = corpus.dictionary
    for nb in (1 << 10, 1 << 14):
        want = r_filter.build_ish_filter(d, gamma, num_bits=nb)
        got = t_filter.build_ish_filter(d, gamma, num_bits=nb)
        np.testing.assert_array_equal(got.bits, want.bits)
        np.testing.assert_array_equal(got.member_tokens, want.member_tokens)
    probe = np.arange(0, 256, dtype=np.int32)
    bits = t_filter.device_words(want.bits, "cpu")
    np.testing.assert_array_equal(
        t_filter.token_in_filter(bits, want.num_bits, want.num_hashes, torch.as_tensor(probe)).numpy(),
        np.asarray(r_filter.token_in_filter(jnp.asarray(want.bits), want.num_bits,
                                            want.num_hashes, jnp.asarray(probe))))


@pytest.mark.parametrize("gamma", [0.5, 0.8, 1.0])
@pytest.mark.parametrize("scheme", r_sig.SIG_NAMES)
def test_entity_signatures_array_equal(corpus, scheme, gamma):
    lsh = r_sig.LshParams(bands=4, rows=2)
    want = r_sig.entity_signatures(scheme, corpus.dictionary, gamma, lsh)
    got = t_sig.entity_signatures(scheme, corpus.dictionary, gamma, t_sig.LshParams(4, 2))
    np.testing.assert_array_equal(got.sig, want.sig)
    np.testing.assert_array_equal(got.entity_id, want.entity_id)
    assert got.sig.dtype == want.sig.dtype and got.entity_id.dtype == want.entity_id.dtype


@pytest.mark.parametrize("max_variants", [256, 5])
@pytest.mark.parametrize("gamma", [0.3, 0.8, 1.0])
def test_variant_keys_array_equal(gamma, max_variants):
    # entities up to 9 tokens: lengths whose subset count reaches the
    # 4 * max_variants cap run the recursion, the others the vectorised path
    c = r_make_corpus(num_docs=2, doc_len=32, vocab_size=300, num_entities=60,
                      max_entity_len=9, min_entity_len=1, seed=9)
    want = r_var.variant_keys(c.dictionary, gamma, max_variants)
    got = t_var.variant_keys(c.dictionary, gamma, max_variants)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["word", "prefix"])
def test_inverted_index_array_equal(corpus, kind):
    want = r_index.build_inverted_index(corpus.dictionary, kind, 0.8)
    got = t_index.build_inverted_index(corpus.dictionary, kind, 0.8)
    for f in ("offsets", "postings", "postings_padded"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.max_postings == want.max_postings
    rng = np.random.default_rng(0)
    win = _windows("pad_heavy", rng, shape=(20, 6)) % 256
    np.testing.assert_array_equal(
        t_index.query_inverted(torch.as_tensor(want.postings_padded), torch.as_tensor(win),
                               torch.as_tensor(win != 0)).numpy(),
        np.asarray(r_index.query_inverted(jnp.asarray(want.postings_padded), jnp.asarray(win),
                                          jnp.asarray(win != 0))))


@pytest.mark.parametrize("gamma", [0.6, 0.8])
def test_variant_index_array_equal(corpus, gamma):
    want = r_index.build_variant_index(corpus.dictionary, gamma)
    got = t_index.build_variant_index(corpus.dictionary, gamma)
    for f in ("keys1", "keys2", "entity_id", "n_buckets", "bucket_cap", "dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    # probe with the entities' own variant keys and with misses
    k1, k2, _ = r_var.variant_keys(corpus.dictionary, gamma)
    q1 = np.concatenate([k1, k1[:5] ^ np.uint32(1)])
    q2 = np.concatenate([k2, k2[:5]])
    ref = r_index.query_variant(jnp.asarray(want.keys1), jnp.asarray(want.keys2),
                                jnp.asarray(want.entity_id), want.n_buckets,
                                jnp.asarray(q1), jnp.asarray(q2))
    out = t_index.query_variant(_t(want.keys1), _t(want.keys2), torch.as_tensor(want.entity_id),
                                want.n_buckets, _t(q1), _t(q2))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dist", ["zipf", "uniform", "bimodal"])
def test_make_corpus_array_equal(dist):
    kw = dict(num_docs=5, doc_len=40, vocab_size=400, num_entities=30, max_entity_len=6,
              mention_dist=dist, seed=13)
    want, got = r_make_corpus(**kw), t_make_corpus(**kw)
    np.testing.assert_array_equal(got.doc_tokens, want.doc_tokens)
    assert got.planted == want.planted
    np.testing.assert_array_equal(got.mention_freq, want.mention_freq)
    for f in ("tokens", "lengths", "freq", "token_weight", "entity_weight"):
        np.testing.assert_array_equal(getattr(got.dictionary, f), getattr(want.dictionary, f))
