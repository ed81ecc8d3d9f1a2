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
from repro_torch.kernels import fused_probe as fp
from repro_torch.kernels import jaccard_verify as jv
from repro_torch.kernels import ops

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
