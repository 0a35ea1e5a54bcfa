"""paddle_tpu_torch.serving.spec_decode — draft-verify speculative decoding
(counterpart of paddle_tpu/serving/spec_decode.py).

A small drafter model proposes ``K`` tokens per iteration and the target
checks them all in one ``[B, K+1]`` forward. The acceptance rule is exact:
the sampler is the seeded Gumbel-max of ``serving.sampling``, so the token a
request emits at generated-token index ``i`` is a function of (the
target's logits there, the request key, ``i``). The verify step replays
that draw on the target's own logits at every drafted position; a draft
token is accepted iff it equals what plain decode would sample there, at
any temperature. The emitted tokens are the ones plain decode would sample
from the verify's logits; the first mismatch yields the target's own
sample as a correction token, and a round that accepts every draft yields
a bonus (K+1)-th token. A wrong drafter costs throughput, never a token.
In float32 the verify's logits agree with decode's and so do the tokens,
greedy and sampled (the tests, ``chip_smoke.py`` phase 5). In bf16 the
verify runs the target over ``B (K+1)`` rows and the paged kernel's 8-row
instance, where decode runs ``B`` rows and its 1-row instance, so a logit
can differ in its last bits and a near-tie can go the other way;
``chip_smoke.py`` phase 5b reports how often (PERF.md).

A steady round is two graph replays (the reference's two executable
calls, ``spec_decode.py:19-38``) and one device-to-host read:

* the draft round: K+1 chained ``[B, 1]`` drafter steps in one body. Steps
  0..K-1 propose ``d_1..d_K`` with the same Gumbel noise the target will
  use at those token indices; step K only ingests ``d_K`` into the
  drafter's KV, so the drafter never trails the accepted sequence;
* the verify: one ``[B, K+1]`` target forward over ``[last, d_1..d_K]``
  through the paged kernel at a span of ``T = K+1`` rows, the exact
  replay, ``accepts`` by cumulative product, ``emitted = accepts + 1``
  capped at ``max_seq_len - cur_lens``, cursors advanced on the device.
  An MoE target routes each of the ``B (K+1)`` rows as its own group
  (``moe_rows``), as plain decode routes each slot's one row, so a
  drafted row never loses its expert slot to its neighbours. The
  reference routes a slot's K+1 rows as one group, with capacity
  ``ceil((K+1) cf k / E)``, so its MoE verify can drop a row plain decode
  keeps and emit other tokens (ROADMAP queue 3).

Both bodies read and write the engine's persistent slot-state buffers
(``serving.engine``), so the fast path's rebuild, audit and demotion
apply unchanged; the audit also covers the drafter's block tables.

Rollback without bookkeeping: the verify writes K+1 KV rows, but a
rejection advances the cursors only by the emitted count. Rows past the
new cursor hold rejected drafts; every read masks them and the next
round's writes cover them before any query reaches them. No block is
allocated for speculation: writes past a slot's budgeted blocks go to the
garbage block, and so do writes past the table's last row at the cache
ceiling (``models.gpt.paged_write_rows``).

The drafter's KV rides its own ``BlockPool`` and block tables with the
target's block geometry, budgeted at admission like the target's.

Weight hot-swap: ``swap_weights(state, draft_state=...)`` stages both
states before either model changes, copies them in place (neither graph is
recaptured), and rebuilds every in-flight slot's drafter KV from its token
history under the new drafter weights. Acceptance is kept per weight
generation (``acceptance_by_generation``), so a swap's effect on it is
visible. ``reprime`` drops all three decode graphs; the target's prefill
graphs stay.

The drafter's prompt ingestion (the reference's ``_draft_prefill_pure``)
replays one captured graph per bucket, like the target's prefill: the
drafter's model, pools and table row, K/V written, nothing sampled
(``serving.draft_prefill_compiles`` counts its captures).

Handoff: ``import_request_kv`` adopts a plain engine's export: the
target's KV verbatim, while the drafter ingests the prompt again (its KV
never crosses). Only fresh handoffs are adopted (``cur_len`` equal to the
prompt's length).

Fault points: the engine's decode points before a round, and
``draft_garbage``, which replaces the drafter's proposals with token 0
between the draft round and the verify: acceptance collapses, the tokens
do not change.

Not ported yet: the mesh refusals and ``describe_sharding`` (with the
sharded serving of ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.paged_attention import MAX_SPAN, select_paged_kernel
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..profiler import tracing as _tracing
from ..testing import faults as _faults
from . import sampling as _sampling
from .block_pool import BlockPool
from ..convert import _linear_weight_names
from .engine import (GenerationEngine, StepGraph, _PrefillBucket,
                     _refresh_head)
from .engine import _counters as _serving_counters

__all__ = ["DraftVerifyEngine"]

_counters = _registry.scoped_counters("serving", {
    "spec_rounds": 0, "spec_slot_rounds": 0, "spec_proposed": 0,
    "spec_accepted": 0, "spec_emitted": 0, "draft_prefills": 0,
    "draft_kv_blocks_hwm": 0, "draft_swaps": 0,
    "draft_prefill_compiles": 0})
# weight generations whose acceptance keeps its own gauge; older ones fold
# into one ".historic" rollup, so frequent swaps add no registry keys
SPEC_ACCEPT_KEEP_GENERATIONS = 4


class DraftVerifyEngine(GenerationEngine):
    """A :class:`GenerationEngine` whose decode loop is draft-verify
    speculative decoding. Admission, paged-KV budgeting and prefix reuse
    are inherited; the scheduler finds :meth:`decode_step_spec` and takes
    1 to K+1 tokens per slot per iteration.

    ``draft_model`` must share the target's vocabulary (acceptance compares
    token ids), cover ``max_seq_len`` positions and live on the engine's
    device; depth, width and heads are free. ``draft_k`` is held to
    ``1 <= K <= 7``: the verify span of K+1 rows goes through the paged
    kernel, which takes at most 8."""

    def __init__(self, model, draft_model, draft_k=4, draft_num_blocks=None,
                 **kw):
        self.draft_k = int(draft_k)
        if not 1 <= self.draft_k <= MAX_SPAN - 1:
            raise ValueError(
                f"draft_k must be in [1, {MAX_SPAN - 1}] (the verify span of "
                f"draft_k + 1 rows goes through the paged kernel, which "
                f"takes at most {MAX_SPAN}); got {draft_k}")
        super().__init__(model, **kw)
        dgpt = getattr(draft_model, "gpt", draft_model)
        if not hasattr(dgpt, "blocks") or not hasattr(dgpt, "embeddings"):
            raise TypeError("draft_model needs a GPTModel-shaped decoder; "
                            f"got {type(draft_model).__name__}")
        if dgpt.cfg.vocab_size != self._gpt.cfg.vocab_size:
            raise ValueError(
                f"drafter vocab {dgpt.cfg.vocab_size} != target vocab "
                f"{self._gpt.cfg.vocab_size}: acceptance compares token ids, "
                "the vocabularies must match")
        if dgpt.cfg.seq_len < self.max_seq_len:
            raise ValueError(
                f"drafter position range {dgpt.cfg.seq_len} < engine "
                f"max_seq_len {self.max_seq_len}")
        if dgpt.device != self.device:
            raise ValueError(
                f"the drafter lives on {dgpt.device} but the engine runs on "
                f"{self.device}")
        draft_model.eval()
        self._draft_model = draft_model
        self._dgpt = dgpt
        dwte = dgpt.embeddings.word_embeddings.weight
        self._ddtype = dwte.dtype
        self._dhead_w = dwte.detach().float()
        self._dstate = dict(dgpt.state_dict(keep_vars=True))
        self._dnames = list(self._dstate)
        self._dlinear = _linear_weight_names(dgpt)

        # the drafter's paged kernel resolves separately against its own
        # head_dim and dtype, with the same requested policy
        self._draft_kernel, self._draft_kernel_reason = select_paged_kernel(
            kw.get("paged_kernel"), device=self.device,
            head_dim=dgpt.blocks[0].attn.head_dim, dtype=self._ddtype)
        _explain.record("serving_paged_kernel", op="DraftVerifyEngine",
                        why=self._draft_kernel_reason,
                        paged_kernel=self._draft_kernel, role="draft")

        B, M = self.max_batch_size, self.blocks_per_slot
        if draft_num_blocks is None:
            draft_num_blocks = 1 + B * M
        self.draft_pool = BlockPool(draft_num_blocks, name="draft")
        Nb, bs = self.draft_pool.num_blocks, self.block_size
        self._dkv = [
            tuple(torch.zeros((Nb, bs, blk.attn.n_head, blk.attn.head_dim),
                              dtype=self._ddtype, device=self.device)
                  for _ in range(2))
            for blk in dgpt.blocks]
        self._draft_tables = np.zeros((B, M), np.int32)
        self._draft_blocks = [[] for _ in range(B)]
        # prompt rows the drafter's KV holds per slot (it has no prefix
        # cache, so it can trail the target's chunk cursor)
        self._draft_ingested = [0] * B
        # per-slot token history, prompt and every emitted token (the
        # pending last one included): len == cur_len + 1 for an installed
        # slot, and the drafter's KV rows 0..cur_len-1 hold
        # history[:cur_len], which is what a swap re-ingests
        self._slot_tokens = [[] for _ in range(B)]
        # weight generation (the engine's swaps applied so far) ->
        # [accepted, proposed]; a re-prime changes no weights and opens no
        # generation
        self._gen_accept = {}
        self._accept_historic = [0, 0]

        dev = self.device
        self._d_dtables = torch.zeros((B, M), dtype=torch.int32, device=dev)
        self._d_drafts = torch.zeros((B, self.draft_k), dtype=torch.int64,
                                     device=dev)
        # one round's result, read back at once: the sampled block
        # [B, K+1], then accepts and emitted
        self._d_round = torch.zeros((B, self.draft_k + 3), dtype=torch.int32,
                                    device=dev)
        self._draft_graph = StepGraph(self._draft_body, dev)
        self._verify_graph = StepGraph(self._verify_body, dev)
        # bucket length -> the drafter's prefill bucket (K/V only)
        self._draft_buckets: dict = {}

    # ------------------------------------------------------- step bodies --
    def _draft_body(self):
        """K+1 chained drafter steps: step j feeds each slot's chained
        token at row ``cur_len + j`` and, for j < K, samples the proposal
        with the Gumbel draw of token index ``gen_idx + j``; step K only
        writes ``d_K``'s KV row (``_draft_round_pure``)."""
        with torch.no_grad():
            lens, feed = self._d_lens, self._d_last
            for j in range(self.draft_k + 1):
                rows = lens + j
                positions = rows.clamp(max=self.max_seq_len - 1)
                hidden, _ = self._dgpt(
                    feed.unsqueeze(1),
                    position_ids=positions.long().unsqueeze(1),
                    caches=self._dkv, cache_offsets=positions,
                    seq_lens=rows + 1, block_tables=self._d_dtables,
                    paged_kernel=self._draft_kernel)
                if j == self.draft_k:
                    break
                logits = hidden[:, 0].float() @ self._dhead_w.t()
                gum = _sampling.gumbel_rows(self._d_keys, self._d_gen + j,
                                            logits.shape[-1])
                toks = _sampling.sample_tokens(logits, self._d_temps,
                                               self._d_top_ks,
                                               self._d_top_ps, gum)
                self._d_drafts[:, j].copy_(toks)
                feed = toks.long()

    def _verify_body(self):
        """One ``[B, K+1]`` target forward over ``[last, d_1..d_K]``, the
        exact Gumbel replay at every position, and the accept arithmetic;
        the cursors of active slots advance by ``emitted`` in place
        (``_verify_pure``)."""
        K = self.draft_k
        with torch.no_grad():
            lens, last = self._d_lens, self._d_last
            ids = torch.cat([last.unsqueeze(1), self._d_drafts], dim=1)
            offs = torch.arange(K + 1, dtype=torch.int32, device=lens.device)
            positions = (lens.unsqueeze(1) + offs).clamp(
                max=self.max_seq_len - 1)
            hidden, _ = self._gpt(
                ids, position_ids=positions.long(), caches=self._kv,
                cache_offsets=lens, seq_lens=lens + (K + 1),
                block_tables=self._d_tables,
                paged_kernel=self._paged_kernel, moe_rows=True)
            B = ids.shape[0]
            logits = hidden.float().reshape(B * (K + 1), -1) \
                @ self._head_w.t()
            rep = lambda t: t.repeat_interleave(K + 1, dim=0)  # noqa: E731
            idxs = (self._d_gen.unsqueeze(1) + offs).reshape(-1)
            gum = _sampling.gumbel_rows(rep(self._d_keys), idxs,
                                        logits.shape[-1])
            sampled = _sampling.sample_tokens(
                logits, rep(self._d_temps), rep(self._d_top_ks),
                rep(self._d_top_ps), gum).reshape(B, K + 1)
            matches = (sampled[:, :K].long() == ids[:, 1:]).int()
            accepts = matches.cumprod(dim=1).sum(dim=1).int()
            active = self._d_active
            emitted = torch.where(
                active,
                torch.minimum(accepts + 1, self.max_seq_len - lens),
                torch.zeros_like(accepts)).int()
            last_tok = sampled.gather(
                1, (emitted - 1).clamp(min=0).long().unsqueeze(1))[:, 0]
            last.copy_(torch.where(active & (emitted > 0), last_tok.long(),
                                   last))
            lens.add_(emitted)
            self._d_gen.add_(emitted.long())
            out = self._d_round
            out[:, :K + 1].copy_(sampled)
            out[:, K + 1].copy_(accepts)
            out[:, K + 2].copy_(emitted)

    def _mirrors(self):
        return super()._mirrors() + [(self._d_dtables, self._draft_tables)]

    # --------------------------------------------------------- admission --
    def can_admit(self, prompt_ids, max_new_tokens=None):
        """Both pools must cover the worst case: the target's (cold prefix
        blocks count as evictable) and the drafter's (no prefix sharing:
        the drafter always ingests the whole prompt)."""
        if not super().can_admit(prompt_ids, max_new_tokens):
            return False
        return self.blocks_needed(len(prompt_ids), max_new_tokens) \
            <= self.draft_pool.free_count()

    def can_import(self, payload):
        """The target's pool must cover the payload's blocks, and the
        drafter's its whole ceiling: the token budget is not known on this
        side, so the drafter's reservation at import takes
        ``blocks_per_slot``."""
        if not super().can_import(payload):
            return False
        return self.blocks_per_slot <= self.draft_pool.free_count()

    def import_request_kv(self, slot, payload, prompt_ids=None):
        """Adopt a handoff: the target's KV verbatim
        (``GenerationEngine.import_request_kv``), then the drafter's
        blocks are reserved and the drafter ingests the prompt here.
        ``prompt_ids`` is required, and only a fresh handoff (``cur_len``
        equal to the prompt's length) is adopted: past that the drafter
        would miss generated context. A failed drafter ingestion undoes
        the adoption."""
        if prompt_ids is None:
            raise ValueError(
                "DraftVerifyEngine.import_request_kv needs prompt_ids (the "
                "drafter ingests the prompt again)")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if int(payload["cur_len"]) != len(prompt):
            raise ValueError(
                "DraftVerifyEngine adopts fresh prefill handoffs only "
                f"(payload cur_len {payload['cur_len']} != prompt length "
                f"{len(prompt)}): the drafter cannot rebuild generated "
                "context")
        first = super().import_request_kv(slot, payload,
                                          prompt_ids=prompt_ids)
        try:
            self._install_extra(slot, prompt, None)
        except Exception:
            super().release(slot)
            raise
        self._slot_tokens[slot] = [int(t) for t in prompt] + [int(first)]
        return first

    def _reserve_extra(self, slot, prompt, max_new_tokens):
        """Reserve the drafter's worst-case blocks at admission (chunked
        admissions call this from ``begin_prefill``)."""
        if self._draft_blocks[slot]:
            return  # already reserved (chunked admission)
        need = self.blocks_needed(len(prompt), max_new_tokens)
        fresh = self.draft_pool.alloc(need)
        self._draft_blocks[slot] = fresh
        self._draft_tables[slot] = 0
        self._draft_tables[slot, :need] = fresh
        self._draft_ingested[slot] = 0
        used = self.draft_pool.in_use()
        if used > _counters["draft_kv_blocks_hwm"]:
            _counters["draft_kv_blocks_hwm"] = used

    def _draft_bucket(self, L):
        """The drafter's prefill bucket of length ``L``, made at its first
        use; its graph shares the target's prefill pool."""
        pb = self._draft_buckets.get(L)
        if pb is None:
            pb = self._draft_buckets[L] = _PrefillBucket(
                self, L, self._prefill_graph_pool(), self._dgpt, self._dkv,
                None, counter="draft_prefill_compiles")
        return pb

    def _draft_ingest(self, slot, prompt, end):
        """Fill the drafter's KV rows up to ``end`` from its own cursor, in
        one bucket-padded window through the gather path, by its bucket's
        graph. No sampling: the target's prefill sample is the first
        token."""
        start = self._draft_ingested[slot]
        if end <= start:
            return
        window = prompt[start:end]
        self._run_prefill(self._draft_bucket(self.bucket_for(len(window))),
                          window, end, start, self._draft_tables[slot],
                          role="draft")
        self._draft_ingested[slot] = end
        _counters["draft_prefills"] += 1

    def _chunk_extra(self, slot, prompt, start, end):
        self._draft_ingest(slot, prompt, end)

    def _install_extra(self, slot, prompt, max_new_tokens):
        self._reserve_extra(slot, prompt, max_new_tokens)
        try:
            self._draft_ingest(slot, prompt, len(prompt))
        except Exception:
            self._drop_draft(slot)
            raise

    def _install_slot(self, slot, prompt, table_ids, bt_row, tok, key,
                      temperature, top_k, top_p, matched_prefix,
                      max_new_tokens):
        super()._install_slot(slot, prompt, table_ids, bt_row, tok, key,
                              temperature, top_k, top_p, matched_prefix,
                              max_new_tokens)
        self._slot_tokens[slot] = [int(t) for t in prompt] + [int(tok)]

    def _drop_draft(self, slot):
        if self._draft_blocks[slot]:
            self.draft_pool.decref(self._draft_blocks[slot])
            self._draft_blocks[slot] = []
        self._draft_tables[slot] = 0
        self._draft_ingested[slot] = 0

    def release(self, slot):
        self._drop_draft(slot)
        self._slot_tokens[slot] = []
        super().release(slot)

    def _finish_decode(self, active, n_active, toks):
        # a plain decode_step on a spec engine keeps the history too
        super()._finish_decode(active, n_active, toks)
        for b in np.nonzero(active)[0]:
            self._slot_tokens[b].append(int(toks[b]))

    # ------------------------------------------------------- weight swap --
    def swap_weights(self, state, source=None, draft_state=None):
        """Target hot-swap, optionally with the drafter in the same commit.

        Without ``draft_state`` this is the inherited target swap: tokens
        stay those of plain decode (every draft is checked against the new
        target), but the drafter guesses from stale weights, so acceptance
        falls. With it, the drafter's state is resolved, checked and staged
        before the target's, so a refusal of either leaves both models as
        they were; then both are copied in place and every in-flight
        slot's drafter KV is rebuilt from its token history under the new
        drafter weights."""
        dstaged = None
        if draft_state is not None:
            dresolved = self._resolve_swap_state(draft_state,
                                                 names=self._dnames)
            dstaged = self._stage_swap(dresolved, self._dnames,
                                       self._dstate, self._dlinear)
        super().swap_weights(state, source=source)
        if dstaged is None:
            return
        self._commit_swap(self._dnames, self._dstate, dstaged)
        _refresh_head(self._dgpt, self._dhead_w)
        self._rebuild_draft_kv()
        _counters["draft_swaps"] += 1
        _explain.record(
            "serving_draft_swap", op="swap_weights",
            why=f"swapped {len(dstaged)} drafter weights"
                + (f" from {source}" if source else "")
                + "; every in-flight slot's drafter KV was rebuilt from "
                  "its token history",
            weights=len(dstaged), source=source)

    def _rebuild_draft_kv(self):
        """Recompute every in-flight slot's drafter KV under the current
        drafter weights by re-ingesting its token history through
        ``_draft_ingest``, in windows no longer than the largest bucket. A
        slot in the middle of a chunked admission redoes the prompt rows
        its drafter had ingested. Rows past the re-ingested span hold
        stale values, like rejected speculation rows: every read masks
        them and the next round overwrites them."""
        maxw = self.buckets[-1]
        for slot in range(self.max_batch_size):
            if self._active[slot]:
                hist = self._slot_tokens[slot]
                end = int(self._cur_lens[slot])
            elif slot in self._mid_prefill:
                hist = list(self._mid_prefill[slot]["prompt"])
                end = self._draft_ingested[slot]
            else:
                continue
            if len(hist) < end:
                raise RuntimeError(
                    f"slot {slot}: token history ({len(hist)}) shorter "
                    f"than cur_len ({end}); the drafter KV cannot be "
                    "rebuilt")
            self._draft_ingested[slot] = 0
            while self._draft_ingested[slot] < end:
                self._draft_ingest(
                    slot, hist, min(self._draft_ingested[slot] + maxw, end))

    def reprime(self):
        """Transient-fault recovery: drop the draft-round and verify graphs
        with the plain decode graph (see ``GenerationEngine.reprime``)."""
        super().reprime()
        self._draft_graph = StepGraph(self._draft_body, self.device)
        self._verify_graph = StepGraph(self._verify_body, self.device)

    # ------------------------------------------------------------ decode --
    def decode_step_spec(self):
        """One speculative iteration over all slots: the draft round, the
        verify, exact acceptance. Returns per-slot lists of emitted tokens
        (empty for inactive lanes): 1 to K+1 per active slot, each equal to
        what ``decode_step`` would have produced one at a time."""
        active = self._active
        n_active = int(active.sum())
        if n_active == 0:
            raise RuntimeError("decode_step_spec with no active slots")
        if _faults.ACTIVE:
            self._fire_decode_faults()
        K = self.draft_k
        rt0 = _tracing.clock() if _tracing.enabled() else 0.0
        with _registry.time_block("decode_step", scope="serving"):
            self._prepare_fast((self._draft_graph, self._verify_graph))
            self._draft_graph()
            if _faults.ACTIVE and _faults.fire("draft_garbage"):
                # a worst-case-wrong drafter: every proposal replaced by a
                # constant; the verify must reject them without changing a
                # token (the drafter's own KV rows are overwritten by the
                # next round either way)
                self._d_drafts.zero_()
            self._verify_graph()
            res = self._d_round.cpu().numpy()
        sampled, accepts, emitted = res[:, :K + 1], res[:, K + 1], \
            res[:, K + 2]
        out = [[] for _ in range(self.max_batch_size)]
        total = 0
        c = _counters
        gen = self._weight_gen
        gen_acc = self._gen_accept.setdefault(gen, [0, 0])
        for b in np.nonzero(active)[0]:
            m = int(emitted[b])
            toks = [int(t) for t in sampled[b, :m]]
            out[b] = toks
            total += m
            # host mirrors advance in lockstep with the device copies
            self._cur_lens[b] += m
            self._gen_idx[b] += m
            if m:
                self._last_tokens[b] = toks[-1]
                self._slot_tokens[b].extend(toks)
            c["spec_accepted"] += int(accepts[b])
            c["spec_proposed"] += K
            c["spec_emitted"] += m
            gen_acc[0] += int(accepts[b])
            gen_acc[1] += K
        c["spec_rounds"] += 1
        c["spec_slot_rounds"] += n_active
        _registry.gauge_set(f"serving.spec_acceptance.gen{gen}",
                            round(gen_acc[0] / gen_acc[1], 4))
        if len(self._gen_accept) > SPEC_ACCEPT_KEEP_GENERATIONS:
            self._retire_old_generations()
        sc = _serving_counters
        sc["decode_steps"] += 1
        sc["active_slot_steps"] += n_active
        sc["tokens_generated"] += total
        _registry.gauge_set("serving.batch_occupancy",
                            n_active / self.max_batch_size)
        if rt0:
            _tracing.add_span(None, "spec_round", rt0, _tracing.clock())
        return out

    # -------------------------------------------------------------- stats --
    def acceptance_rate(self):
        p = _counters["spec_proposed"]
        return _counters["spec_accepted"] / p if p else 0.0

    def _retire_old_generations(self):
        """Fold the generations beyond the newest
        ``SPEC_ACCEPT_KEEP_GENERATIONS`` into the ``.historic`` rollup and
        drop their gauges."""
        while len(self._gen_accept) > SPEC_ACCEPT_KEEP_GENERATIONS:
            g = min(self._gen_accept)
            acc, prop = self._gen_accept.pop(g)
            self._accept_historic[0] += acc
            self._accept_historic[1] += prop
            _registry.gauge_drop(f"serving.spec_acceptance.gen{g}")
        if self._accept_historic[1]:
            _registry.gauge_set(
                "serving.spec_acceptance.historic",
                round(self._accept_historic[0]
                      / self._accept_historic[1], 4))

    def acceptance_by_generation(self):
        """Acceptance rate per weight generation (the number of swaps
        applied before the round): a swap that also swapped the drafter
        shows recovery here, a target-only swap shows decay."""
        return {int(g): (a / p if p else 0.0)
                for g, (a, p) in sorted(self._gen_accept.items())}

    def accepted_len_mean(self):
        """Mean tokens emitted per slot per round (1.0 = plain decode's
        rate, K+1 = a drafter the target always agrees with)."""
        r = _counters["spec_slot_rounds"]
        return _counters["spec_emitted"] / r if r else 0.0

    def stats(self):
        return {**super().stats(),
                "draft_paged_kernel": self._draft_kernel,
                "draft_paged_kernel_reason": self._draft_kernel_reason,
                "draft_k": self.draft_k,
                "acceptance_rate": self.acceptance_rate(),
                "accepted_len_mean": self.accepted_len_mean(),
                "draft_kv_blocks_total": self.draft_pool.usable_blocks,
                "draft_kv_blocks_in_use": self.draft_pool.in_use()}
