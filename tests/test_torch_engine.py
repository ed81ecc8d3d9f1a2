"""repro_torch's engine and operator against the JAX package.

The candidate front end must give the reference's candidate dict field
for field; ``execute`` must give the reference's match sets for every
pure plan and a hybrid one, with ``use_kernel`` on and off, both from
the port's own ``prepare`` and from the reference's prepared structures
(``prepared_from_arrays``). The port runs on the CPU here, so its
kernels run as their plain PyTorch forms.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.cost_model import SideCost
from repro.core.eejoin import EEJoinConfig as RConfig
from repro.core.eejoin import EEJoinOperator as ROperator
from repro.core.plan import Plan as RPlan
from repro.core.plan import PlanSide as RPlanSide
from repro.data.synth import make_corpus
from repro.extraction import engine as r_eng
from repro.extraction import results as r_res
from repro_torch.core import plan as t_plan
from repro_torch.core.cost_model import SideCost as TSideCost
from repro_torch.core.eejoin import EEJoinConfig as TConfig
from repro_torch.core.eejoin import EEJoinOperator as TOperator
from repro_torch.core.eejoin import prepared_from_arrays
from repro_torch.extraction import engine as t_eng
from repro_torch.extraction import results as t_res

GAMMA = 0.8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(num_docs=8, doc_len=64, vocab_size=512, num_entities=40,
                       max_entity_len=6, seed=1)


def _docs(rng, D, T, vocab=2048, pad_frac=0.1):
    d = rng.integers(1, vocab, size=(D, T)).astype(np.int32)
    d[rng.random((D, T)) < pad_frac] = 0
    return d


def _filter(rng, num_bits=1 << 12, density=0.05):
    w = (rng.random((num_bits // 32, 32)) < density).astype(np.uint32)
    bits = (w << np.arange(32, dtype=np.uint32)).sum(axis=1).astype(np.uint32)
    return ((jnp.asarray(bits), num_bits, 3),
            (torch.as_tensor(bits.view(np.int32)), num_bits, 3))


def _assert_cands_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = want[k]
        g = got[k]
        if k == "variant_keys":
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))
            continue
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.astype(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=k)
        assert g.shape == w.shape, k


FRONT_END_CASES = [
    (scheme, kernel_compact, adaptive, NC)
    for scheme in ("word", "prefix", "lsh", "variant")
    for kernel_compact, adaptive, NC in (
        (True, False, 512), (False, False, 512), (True, True, 512),
        (True, False, 12 * 48 * 6),  # NC = D*T*L: dense in-kernel signatures
    )
] + [("prefix", True, False, 40), ("variant", True, False, 40)]  # overflow surfaced


@pytest.mark.parametrize("scheme,kernel_compact,adaptive,NC", FRONT_END_CASES)
def test_fused_filter_compact_matches_reference(scheme, kernel_compact, adaptive, NC):
    rng = np.random.default_rng(len(scheme) + NC)
    docs = _docs(rng, 12, 48, vocab=400, pad_frac=0.1)
    rflt, tflt = _filter(rng, density=0.1)
    kw = dict(gamma=GAMMA, scheme=scheme, max_candidates=NC, use_kernel=True,
              kernel_compact=kernel_compact, adaptive_lanes=adaptive)
    want = r_eng.fused_filter_compact(jnp.asarray(docs), 6, rflt, r_eng.ExtractParams(**kw))
    got = t_eng.fused_filter_compact(torch.as_tensor(docs), 6, tflt, t_eng.ExtractParams(**kw))
    _assert_cands_equal(got, want)


@pytest.mark.parametrize("pad_frac", [0.0, 0.6])
@pytest.mark.parametrize("with_filter", [True, False])
def test_unfused_front_end_matches_reference(pad_frac, with_filter):
    rng = np.random.default_rng(int(pad_frac * 10))
    docs = _docs(rng, 6, 40, pad_frac=pad_frac)
    rflt, tflt = _filter(rng) if with_filter else (None, None)
    rb, rs = r_eng.survival_mask(jnp.asarray(docs), 5, rflt, use_kernel=False)
    tb, ts = t_eng.survival_mask(torch.as_tensor(docs), 5, tflt)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    for NC in (64, 4096):
        _assert_cands_equal(t_eng.compact_candidates(tb, ts, NC),
                            r_eng.compact_candidates(rb, rs, NC))


@pytest.mark.parametrize("L,NC", [(33, 4096), (40, 4096), (40, 100)])
def test_long_windows_name_the_missing_kernel(L, NC):
    """Windows longer than 32 tokens, once refused for want of the
    window_filter kernel, run through it (its plain form here) and give
    the reference's candidates, overflow included."""
    rng = np.random.default_rng(L + NC)
    docs = _docs(rng, 5, 48, vocab=400, pad_frac=0.1)
    rflt, tflt = _filter(rng, density=0.3)
    kw = dict(gamma=GAMMA, scheme="prefix", max_candidates=NC, use_kernel=True)
    want = r_eng.fused_filter_compact(jnp.asarray(docs), L, rflt, r_eng.ExtractParams(**kw))
    got = t_eng.fused_filter_compact(torch.as_tensor(docs), L, tflt, t_eng.ExtractParams(**kw))
    _assert_cands_equal(got, want)
    assert 0 < int(got["n_survive"]) < docs.size * L
    tb, ts = t_eng.survival_mask(torch.as_tensor(docs), L, tflt, use_kernel=True)
    assert torch.equal(ts, t_eng.survival_mask(torch.as_tensor(docs), L, tflt)[1])


@pytest.mark.parametrize("scheme", [("index", "prefix"), ("ssjoin", "lsh")])
def test_execute_long_entities_matches_reference(scheme):
    """execute(use_kernel=True) and execute_sharded at L > 32 equal the
    reference's match set."""
    c = make_corpus(num_docs=4, doc_len=64, vocab_size=512, num_entities=30, min_entity_len=2,
                    max_entity_len=40, seed=5)
    assert c.dictionary.max_len > 32
    rplan, tplan = _plans(0, scheme, scheme)
    cfg = dict(gamma=GAMMA, use_kernel=True, max_candidates=4 * 64 * c.dictionary.max_len,
               result_capacity=4096)
    rop = ROperator(c.dictionary, RConfig(**cfg))
    want = rop.execute(rop.prepare(rplan), jnp.asarray(c.doc_tokens))
    assert len(want.to_set()) > 0
    top = TOperator(c.dictionary, TConfig(**cfg), device=CPU)
    tprep = top.prepare(tplan)
    _assert_same_matches(top.execute(tprep, c.doc_tokens), want, GAMMA)
    _assert_same_matches(top.execute_sharded(tprep, c.doc_tokens, shard_docs=2), want, GAMMA)


def test_extract_params_validation():
    base = dict(gamma=GAMMA, scheme="prefix")
    with pytest.raises(ValueError, match="kernel_compact=True"):
        t_eng.ExtractParams(**base, kernel_compact=True)
    with pytest.raises(ValueError, match="adaptive_lanes=True"):
        t_eng.ExtractParams(**base, adaptive_lanes=True)
    with pytest.raises(ValueError, match="adaptive_lanes=True"):
        t_eng.ExtractParams(**base, use_kernel=True, lane_width=8)
    with pytest.raises(ValueError, match="lane_width"):
        t_eng.ExtractParams(**base, use_kernel=True, adaptive_lanes=True, lane_width=5000)
    with pytest.raises(ValueError, match="kernel_sigs=True"):
        t_eng.ExtractParams(**base, use_kernel=True, kernel_sigs=True)
    with pytest.raises(ValueError, match="gamma"):
        t_eng.ExtractParams(gamma=0.0, scheme="word")
    with pytest.raises(ValueError, match="scheme"):
        t_eng.ExtractParams(gamma=GAMMA, scheme="bogus")
    assert t_eng.ExtractParams(**base, use_kernel=True).kernel_compact is True
    with pytest.raises(ValueError, match="overflows int32"):
        t_eng.check_flat_index_space(1 << 16, 1 << 12, 8)


@pytest.mark.parametrize("n,density,capacity", [(1, 1.0, 4), (300, 0.05, 8), (300, 0.9, 64)])
def test_select_helpers_match_reference(n, density, capacity):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < density
    for g, w in zip(t_res.select_nonzero(torch.as_tensor(mask), capacity),
                    r_res.select_nonzero(jnp.asarray(mask), capacity)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = rng.integers(0, 6, size=5).astype(np.int32)
    lanes = np.where(np.arange(8)[None] < counts[:, None], rng.integers(0, 999, (5, 8)), -1)
    lanes = lanes.astype(np.int32)
    for g, w in zip(t_res.select_from_tiles(torch.as_tensor(counts), torch.as_tensor(lanes), 8),
                    r_res.select_from_tiles(jnp.asarray(counts), jnp.asarray(lanes), 8)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        t_res.gather_from_tiles(torch.as_tensor(counts), torch.as_tensor(lanes[..., None]), 8).numpy(),
        np.asarray(r_res.gather_from_tiles(jnp.asarray(counts), jnp.asarray(lanes[..., None]), 8)))
    with pytest.raises(ValueError, match="lane width"):
        t_res.select_from_tiles(torch.as_tensor(counts), torch.as_tensor(lanes), 9)


def test_operator_needs_cuda_by_default(corpus):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TOperator(corpus.dictionary, TConfig(use_kernel=True))


# ------------------------------------------------------------------ end to end

PLANS = [(0, ("index", s), ("index", s)) for s in ("word", "prefix", "variant")]
PLANS += [(0, ("ssjoin", s), ("ssjoin", s)) for s in ("word", "prefix", "lsh", "variant")]
PLANS += [(12, ("ssjoin", "lsh"), ("index", "variant"))]  # hybrid split


def _plans(split, head, tail):
    rz = SideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    tz = TSideCost(0, 0, 0, 0, 0, 0, 0, 0, 0)
    return (RPlan(split, RPlanSide(*head), RPlanSide(*tail), "job_completion", 0.0, rz, rz, 0),
            t_plan.Plan(split, t_plan.PlanSide(*head), t_plan.PlanSide(*tail), "job_completion",
                        0.0, tz, tz, 0))


def arrays_from_prepared(prepared) -> dict:
    """Either package's PreparedPlan -> the ``prepared_from_arrays`` dict."""
    def host(x, u32=False):
        a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return a.astype(np.uint32) if u32 else a

    out = {}
    for i, s in enumerate(prepared.sides):
        p = f"side{i}."
        out[p + "dict_tokens"] = host(s.ddict.tokens)
        out[p + "token_weight"] = host(s.ddict.token_weight)
        if s.flt is not None:
            out[p + "bits"] = host(s.flt[0], u32=True)
            out[p + "filter"] = np.array([s.flt[1], s.flt[2]])
        if s.sig_table is not None:
            t = s.sig_table
            out[p + "sig_keys1"] = host(t.keys1, u32=True)
            out[p + "sig_keys2"] = host(t.keys2, u32=True)
            out[p + "sig_ents"] = host(t.ents)
        if s.index_parts is not None:
            out[p + "num_parts"] = np.array([len(s.index_parts)])
            for j, part in enumerate(s.index_parts):
                q = f"{p}part{j}."
                out[q + "offset"] = np.array([part.entity_offset])
                if part.postings is not None:
                    out[q + "postings"] = host(part.postings)
                else:
                    out[q + "keys1"] = host(part.keys1, u32=True)
                    out[q + "keys2"] = host(part.keys2, u32=True)
                    out[q + "ents"] = host(part.ents)
    return out


def _scores(m):
    d = np.asarray(m.doc)
    keep = d >= 0
    keys = zip(*(np.asarray(a)[keep].tolist() for a in (m.doc, m.pos, m.length, m.entity)))
    return dict(zip(keys, np.asarray(m.score)[keep].tolist()))


def _assert_same_matches(got, want, gamma):
    """Equal match sets; a differing hit may only be an f32 tie at gamma."""
    ws, gs = _scores(want), _scores(got)
    differ = set(ws) ^ set(gs)
    ties = {k for k in differ if abs(ws.get(k, gs.get(k)) - gamma) <= 1e-5}
    assert differ - ties == set(), sorted(differ - ties)[:5]
    assert len(ties) == 0, f"{len(ties)} threshold ties"
    assert int(got.count) == int(want.count)
    for k in set(ws) & set(gs):
        assert abs(ws[k] - gs[k]) <= 1e-6, k


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("split,head,tail", PLANS)
def test_execute_matches_reference(corpus, split, head, tail, use_kernel):
    rplan, tplan = _plans(split, head, tail)
    cfg = dict(gamma=GAMMA, use_kernel=use_kernel, max_candidates=4096, result_capacity=4096,
               adaptive_lanes=use_kernel and split > 0)
    rop = ROperator(corpus.dictionary, RConfig(**cfg))
    rprep = rop.prepare(rplan)
    want = rop.execute(rprep, jnp.asarray(corpus.doc_tokens))
    assert len(want.to_set()) > 0

    top = TOperator(corpus.dictionary, TConfig(**cfg), device=CPU)
    tprep = top.prepare(tplan)
    _assert_same_matches(top.execute(tprep, corpus.doc_tokens), want, GAMMA)

    # the reference's own structures, carried over: faults in execute
    # show apart from faults in the builds
    carried = prepared_from_arrays(arrays_from_prepared(rprep), tplan, TConfig(**cfg), CPU)
    _assert_same_matches(top.execute(carried, corpus.doc_tokens), want, GAMMA)


@pytest.mark.parametrize("split,head,tail", PLANS)
def test_prepare_builds_reference_arrays(corpus, split, head, tail):
    rplan, tplan = _plans(split, head, tail)
    cfg = dict(gamma=GAMMA, use_kernel=True)
    want = arrays_from_prepared(ROperator(corpus.dictionary, RConfig(**cfg)).prepare(rplan))
    got = arrays_from_prepared(
        TOperator(corpus.dictionary, TConfig(**cfg), device=CPU).prepare(tplan))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_config_fields_match_reference():
    rf = [(f.name, f.default) for f in dataclasses.fields(RConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert [n for n, _ in tf] == [n for n, _ in rf]
    for (n, a), (_, b) in zip(tf, rf):
        if n not in ("lsh", "options"):
            assert a == b, n
