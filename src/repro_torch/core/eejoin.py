"""The EE-Join operator: plan -> prepared structures -> execution.

Usage::

    op = EEJoinOperator(dictionary, EEJoinConfig(use_kernel=True))
    prepared = op.prepare(plan)          # host builds, moved to the GPU
    matches = op.execute(prepared, doc_tokens)

``prepare`` builds each plan side's structures on the host (the ISH
Bloom filter, and a signature table or index partitions) and moves them
to the operator's device; ``execute`` runs every side there and merges
the matches. ``execute_sharded`` streams a batch through the candidate
front end shard by shard, and ``execute_corpus`` streams a corpus that
lives in a file (``extraction.sharded.MemmapCorpus``), with resumable
per-shard checkpoints. Plan choice (statistics, cost model, search) is
not ported yet: plans come from the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import (
    ALGO_INDEX,
    ALGO_SSJOIN,
    ALL_OPTIONS,
    OBJ_JOB,
    CostParams,
)
from repro_torch.core.dictionary import Dictionary
from repro_torch.core.filter import build_ish_filter, device_words
from repro_torch.core.index import INDEX_VARIANT
from repro_torch.core.plan import Plan, PlanSide
from repro_torch.core.signatures import LshParams, entity_signatures
from repro_torch.extraction import engine
from repro_torch.extraction.results import Matches, merge_matches


@dataclasses.dataclass(frozen=True)
class EEJoinConfig:
    gamma: float = 0.8
    sim_name: str = "extra"
    objective: str = OBJ_JOB
    use_filter: bool = True
    max_candidates: int = 8192
    result_capacity: int = 16384
    lsh: LshParams = LshParams()
    options: Sequence[tuple[str, str]] = ALL_OPTIONS
    use_kernel: bool = False
    filter_bits: int = 1 << 18
    # kernel-path lane compaction knobs, forwarded to every side's
    # ExtractParams (validated there)
    adaptive_lanes: bool = False
    lane_width: int | None = None
    kernel_sigs: bool | None = None
    # streaming paths: the per-shard launch mode (ExtractParams.streamed)
    # and the device bytes one staged shard of ``execute_corpus`` may use
    # (None -> sharded.DEFAULT_DEVICE_BUDGET_BYTES)
    streamed: bool | None = None
    device_budget_bytes: int | None = None
    # online replanning of the reference; carried for one-for-one
    # configurations, not read by this port yet
    observe_capacity: int = 128


@dataclasses.dataclass
class PreparedSide:
    """One executable side of a plan (device-resident structures)."""

    side: PlanSide
    params: engine.ExtractParams
    ddict: engine.DeviceDictionary
    flt: tuple | None  # (bits int32 words, num_bits, num_hashes)
    index_parts: list[engine.BuiltIndex] | None = None
    sig_table: engine.SigTable | None = None


@dataclasses.dataclass
class PreparedPlan:
    plan: Plan
    sides: list[PreparedSide]
    max_entity_len: int


def side_sources(side: PreparedSide) -> list:
    """What a side probes, in order: its index partitions or its signature table."""
    return list(side.index_parts) if side.side.algo == ALGO_INDEX else [side.sig_table]


def side_matches(cands: dict, side: PreparedSide, result_capacity: int) -> Matches:
    """Probe + verify one prepared side over compacted candidates."""
    extract = (engine.extract_index_part if side.side.algo == ALGO_INDEX
               else engine.extract_ssjoin_local)
    m: Matches | None = None
    for source in side_sources(side):
        pm = extract(cands, source, side.ddict, side.params)
        m = pm if m is None else merge_matches(m, pm, result_capacity)
    return m


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "EEJoinOperator runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def _side_params(cfg: EEJoinConfig, scheme: str) -> engine.ExtractParams:
    return engine.ExtractParams(
        gamma=cfg.gamma,
        scheme=scheme,
        sim_name=cfg.sim_name,
        use_filter=cfg.use_filter,
        max_candidates=cfg.max_candidates,
        result_capacity=cfg.result_capacity,
        lsh=cfg.lsh,
        use_kernel=cfg.use_kernel,
        adaptive_lanes=cfg.adaptive_lanes,
        lane_width=cfg.lane_width,
        kernel_sigs=cfg.kernel_sigs,
        streamed=cfg.streamed,
    )


def _side_ranges(plan: Plan, E: int):
    """(side, first entity, end entity) of the non-empty plan sides."""
    return [(s, a, b) for s, a, b in ((plan.head, 0, plan.split), (plan.tail, plan.split, E))
            if a < b]


class EEJoinOperator:
    """EE-Join over one dictionary on one device.

    ``device=None`` means ``"cuda"`` and raises ``RuntimeError`` when no
    GPU is present; the operator never moves to the CPU on its own.
    """

    def __init__(self, dictionary: Dictionary, config: EEJoinConfig = EEJoinConfig(),
                 device: torch.device | str | None = None):
        self.dictionary = dictionary
        self.config = config
        self.device = _device(device)

    # -- plan -> device structures -------------------------------------------
    def _prepare_side(self, side: PlanSide, a: int, b: int, hbm_budget: float) -> PreparedSide:
        cfg = self.config
        sl = self.dictionary.slice(a, b)
        ddict = engine.DeviceDictionary.from_host(sl, entity_offset=a, device=self.device)
        flt = None
        if cfg.use_filter:
            f = build_ish_filter(sl, cfg.gamma, num_bits=cfg.filter_bits)
            flt = (device_words(f.bits, self.device), f.num_bits, f.num_hashes)
        prepared = PreparedSide(side=side, params=_side_params(cfg, side.scheme),
                                ddict=ddict, flt=flt)
        if side.algo == ALGO_INDEX:
            prepared.index_parts = engine.build_index_partitions(
                sl, side.scheme, cfg.gamma, int(hbm_budget), entity_offset=a,
                device=self.device,
            )
        elif side.algo == ALGO_SSJOIN:
            esig = entity_signatures(side.scheme, sl, cfg.gamma, cfg.lsh)
            prepared.sig_table = engine.build_sig_table(esig, entity_offset=a, device=self.device)
        else:
            raise ValueError(side.algo)
        return prepared

    def prepare(self, plan: Plan, cost_params: CostParams | None = None) -> PreparedPlan:
        cp = cost_params or CostParams(num_devices=1)
        sides = [self._prepare_side(s, a, b, cp.hbm_budget_bytes)
                 for s, a, b in _side_ranges(plan, self.dictionary.num_entities)]
        return PreparedPlan(plan=plan, sides=sides, max_entity_len=self.dictionary.max_len)

    # -- execution ------------------------------------------------------------
    def side_matches(self, cands: dict, side: PreparedSide) -> Matches:
        return side_matches(cands, side, self.config.result_capacity)

    def execute(self, prepared: PreparedPlan, doc_tokens) -> Matches:
        """Extract every plan side's matches from ``doc_tokens`` [D, T]."""
        cfg = self.config
        docs = torch.as_tensor(doc_tokens, dtype=torch.int32, device=self.device).contiguous()
        out: Matches | None = None
        for side in prepared.sides:
            if cfg.use_kernel:
                cands = engine.fused_filter_compact(
                    docs, prepared.max_entity_len, side.flt, side.params
                )
            else:
                base, surv = engine.survival_mask(docs, prepared.max_entity_len, side.flt)
                cands = engine.compact_candidates(base, surv, side.params.max_candidates)
            m = self.side_matches(cands, side)
            out = m if out is None else merge_matches(out, m, cfg.result_capacity)
        if out is None:
            raise ValueError("empty plan: no side has entities")
        return out

    def _streamed_sides(self, prepared: PreparedPlan, front_end, what: str) -> Matches:
        """Verify every side over the candidates ``front_end(i, side)``
        gives it, merging the matches."""
        if not self.config.use_kernel:
            raise ValueError(
                f"{what} requires EEJoinConfig(use_kernel=True): candidate "
                "streaming runs through the probe kernels' compaction epilogue"
            )
        out: Matches | None = None
        for i, side in enumerate(prepared.sides):
            m = self.side_matches(front_end(i, side), side)
            out = m if out is None else merge_matches(out, m, self.config.result_capacity)
        if out is None:
            raise ValueError("empty plan: no side has entities")
        return out

    def execute_sharded(self, prepared: PreparedPlan, doc_tokens, mesh=None,
                        shard_docs: int | None = None, tile_docs: int | None = None,
                        checkpoint_dir: str | None = None,
                        stream_stats: dict | None = None) -> Matches:
        """Streaming execution: each side's candidates come from the
        sharded streaming front end (``sharded.sharded_filter_compact``),
        then each side verifies over the merged candidate buffer. Equal to ``execute`` with ``use_kernel=True``, which it
        requires. ``mesh`` must be None (shards stream on this device);
        ``checkpoint_dir`` makes the shards resumable (one subdirectory
        per plan side)."""
        from repro_torch.extraction import sharded as S

        docs = torch.as_tensor(doc_tokens, dtype=torch.int32, device=self.device).contiguous()
        return self._streamed_sides(prepared, lambda i, side: S.sharded_filter_compact(
            docs, prepared.max_entity_len, side.flt, side.params, mesh=mesh,
            shard_docs=shard_docs, tile_docs=tile_docs,
            checkpoint_dir=None if checkpoint_dir is None else f"{checkpoint_dir}/side{i}",
            stream_stats=stream_stats,
        ), "execute_sharded")

    def execute_corpus(self, prepared: PreparedPlan, corpus, shard_docs: int | None = None,
                       tile_docs: int | None = None, checkpoint_dir: str | None = None,
                       stream_stats: dict | None = None,
                       fail_after_shards: int | None = None) -> Matches:
        """Corpus-scale execution over a file-backed document set.

        ``corpus`` is a ``sharded.MemmapCorpus`` (or any host [D, T]
        int32 array): shards are file regions staged through one pinned
        host buffer and probed by the streamed kernel, so the corpus is
        never on the device (``config.device_budget_bytes`` sizes the
        shards). With ``checkpoint_dir`` the per-shard lanes are
        persisted (one subdirectory per plan side) and an interrupted
        run resumes to the same matches. Verification runs over the
        merged candidate buffer as in ``execute``.
        """
        from repro_torch.extraction import sharded as S

        cfg = self.config
        return self._streamed_sides(prepared, lambda i, side: S.spill_filter_compact(
            corpus, prepared.max_entity_len, side.flt, side.params,
            device_budget_bytes=cfg.device_budget_bytes, shard_docs=shard_docs,
            tile_docs=tile_docs,
            checkpoint_dir=None if checkpoint_dir is None else f"{checkpoint_dir}/side{i}",
            stream_stats=stream_stats, fail_after_shards=fail_after_shards, device=self.device,
        ), "execute_corpus")


def prepared_from_arrays(arrays: dict[str, np.ndarray], plan: Plan, config: EEJoinConfig,
                         device: torch.device | str) -> PreparedPlan:
    """A ``PreparedPlan`` from prepared structures given as numpy arrays.

    This is how state built elsewhere (the reference package's
    ``prepare``) is carried over. Keys, for side ``i`` (head first, empty
    sides skipped) and index partition ``j``:

    * ``side{i}.dict_tokens`` [E_i, L] int32, ``side{i}.token_weight`` [V] f32;
    * ``side{i}.bits`` [num_bits/32] uint32 and ``side{i}.filter`` =
      [num_bits, num_hashes] when the config filters;
    * ssjoin sides: ``side{i}.sig_keys1``, ``side{i}.sig_keys2`` [B, cap]
      uint32 and ``side{i}.sig_ents`` [B, cap] int32;
    * index sides: ``side{i}.num_parts`` = [P]; per partition
      ``side{i}.part{j}.offset`` = [global entity offset], and
      ``side{i}.part{j}.postings`` [V, P] int32 (word, prefix) or
      ``side{i}.part{j}.keys1``, ``.keys2`` [n_buckets, cap] uint32 and
      ``.ents`` [n_buckets, cap] int32 (variant).
    """
    dev = torch.device(device)
    specs = ([(plan.head, 0)] if plan.split > 0 else []) + [(plan.tail, plan.split)]
    sides = []
    max_len = 0
    for i, (side, offset) in enumerate(specs):
        p = f"side{i}."
        if p + "dict_tokens" not in arrays:
            break  # a pure-head plan has no tail entities
        toks = np.array(arrays[p + "dict_tokens"], np.int32)
        max_len = max(max_len, toks.shape[1])
        ddict = engine.DeviceDictionary(
            tokens=torch.as_tensor(toks, device=dev),
            token_weight=torch.as_tensor(np.array(arrays[p + "token_weight"], np.float32),
                                         device=dev),
            entity_offset=offset,
        )
        flt = None
        if config.use_filter:
            num_bits, num_hashes = (int(v) for v in arrays[p + "filter"])
            flt = (device_words(arrays[p + "bits"], dev), num_bits, num_hashes)
        prepared = PreparedSide(side=side, params=_side_params(config, side.scheme),
                                ddict=ddict, flt=flt)
        if side.algo == ALGO_INDEX:
            parts = []
            for j in range(int(arrays[p + "num_parts"][0])):
                q = f"{p}part{j}."
                part_off = int(arrays[q + "offset"][0])
                if side.scheme == INDEX_VARIANT:
                    k1 = arrays[q + "keys1"]
                    parts.append(engine.built_variant_part(
                        k1, arrays[q + "keys2"], arrays[q + "ents"], k1.shape[0], part_off, dev))
                else:
                    parts.append(engine.BuiltIndex(
                        kind=side.scheme, entity_offset=part_off,
                        postings=torch.as_tensor(np.array(arrays[q + "postings"], np.int32),
                                                 device=dev)))
            prepared.index_parts = parts
        else:
            prepared.sig_table = engine.sig_table_from_arrays(
                arrays[p + "sig_keys1"], arrays[p + "sig_keys2"], arrays[p + "sig_ents"],
                offset, dev)
        sides.append(prepared)
    if not sides:
        raise ValueError("prepared_from_arrays: no 'side0.dict_tokens' in arrays")
    return PreparedPlan(plan=plan, sides=sides, max_entity_len=max_len)
