"""paddle_tpu_torch.serving.scheduler — iteration-level continuous batching
(counterpart of paddle_tpu/serving/scheduler.py).

Each ``step()`` (1) fails queued requests whose deadline passed, (2) admits
queued requests into free slots while the KV block pool can cover their
worst case — one prefill each, which yields the request's first token —
(2b) advances one chunk of every chunked admission, then (3) runs one
decode iteration over every active slot (a speculative engine's round
emits several tokens per slot) and applies per-request stop conditions
(EOS, max tokens, cache capacity, deadline) token by token. A finished
request's slot frees this iteration and can be refilled the next.

``submit()`` on a full queue raises ``QueueFullError`` at once (fast-fail
backpressure). Request transitions set a ``threading.Event`` so a frontend
can block on ``request.result()`` from another thread; ``step()`` itself is
driven from one thread (``serving.GenerationServer`` owns that loop).

A weight swap staged with ``request_swap`` (from any thread) lands at the
top of the next ``step()``, between two decode iterations. A decode error
re-primes the engine and retries the iteration once; a second error in a
row, or a ``FatalEngineError``, propagates to the caller.

A request that carries a ``kv_payload`` (a prefill engine's
``export_request_kv``) is budgeted with ``engine.can_import`` and adopted
with ``engine.import_request_kv`` instead of a prefill, and never chunked.
A payload of another weight generation (``StaleHandoffError``) is answered
with a local prefill under the current weights.

Telemetry: ``serving.requests_*`` counters, ``serving.queue_wait`` /
``serving.ttft`` timings, the log2 histograms ``ttft``, ``queue_wait`` and
``inter_token`` (``registry.histograms``), per-request spans
(``queue_wait``, ``admit`` or ``kv_adopt``, ``decode``) and one
``decode_iter`` span per iteration while tracing is on, and flight events
(``submit``, ``admit``, ``admit_chunked``, ``finish``).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..profiler import tracing as _tracing
from .block_pool import PagePoolExhausted
from .engine import FatalEngineError, StaleHandoffError

_counters = _registry.scoped_counters("serving", {
    "requests_submitted": 0, "requests_completed": 0,
    "requests_rejected": 0, "requests_timeout": 0, "requests_failed": 0,
    "pool_exhausted": 0, "swap_failures": 0, "step_retries": 0,
    "requeued_requests": 0})


class QueueFullError(RuntimeError):
    """Admission queue at capacity — backpressure, retry later."""


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    TIMEOUT = "timeout"
    ERROR = "error"


class GenerationRequest:
    """One generation job: prompt in, token ids out.

    ``timeout_s`` is a wall-clock deadline from submission covering queue
    wait and generation; an expired request fails in the queue or finishes
    early with the tokens it has (``status == "timeout"``). ``seed`` pins
    the request's sampling stream regardless of slot or batch; None takes
    the engine's next sequence number.

    ``kv_payload``: a handoff from a prefill engine
    (``export_request_kv``), adopted at admission instead of a prefill.
    ``trace_id``: the request's trace; None derives it from a pinned
    ``seed`` at submission (``tracing.trace_id_for_seed``)."""

    def __init__(self, prompt_ids, max_new_tokens=32, eos_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None,
                 timeout_s=None):
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("prompt_ids must not be empty")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_id = None if eos_id is None else int(eos_id)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = seed
        self.timeout_s = timeout_s

        self.rid = None
        self.slot = None
        self.kv_payload = None
        self.tokens: list = []
        self.status = RequestStatus.QUEUED
        self.stop_reason = None
        self.error = None
        self.finished = threading.Event()
        self.submit_ts = None
        self.deadline = None
        self.ttft_s = None
        self.trace_id = None
        self.first_tok_ts = None
        self.last_tok_ts = None

    @property
    def done(self):
        return self.finished.is_set()

    def result(self, timeout=None):
        """Block until the request is terminal; returns self. Raises
        ``TimeoutError`` if the wait times out (the request keeps running)."""
        if not self.finished.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} still {self.status} after waiting "
                f"{timeout}s")
        return self

    def __repr__(self):
        return (f"GenerationRequest(rid={self.rid}, status={self.status}, "
                f"tokens={len(self.tokens)}, stop={self.stop_reason})")


class ContinuousBatchScheduler:
    """Bounded admission queue feeding an engine's free slots each step.

    ``prefill_chunk_tokens``: prompts longer than this admit through
    ``engine.begin_prefill`` and advance one block-aligned chunk per
    ``step()``, interleaved with decode iterations. None disables."""

    def __init__(self, engine, max_queue_size=16,
                 prefill_chunk_tokens=None):
        self.engine = engine
        self.max_queue_size = int(max_queue_size)
        self.prefill_chunk_tokens = None if prefill_chunk_tokens is None \
            else int(prefill_chunk_tokens)
        self._queue: collections.deque = collections.deque()
        self._active: dict = {}      # slot -> request
        self._prefilling: dict = {}  # slot -> request (chunked admission)
        self._lock = threading.Lock()
        self._rid = itertools.count(1)
        self._closed = False
        self._t0 = None
        # the engine's counters share this scope's dict
        self._tok_base = _counters.get("tokens_generated", 0)
        # (state, source, draft_state) of the newest staged swap
        self._pending_swap = None
        self.swap_count = 0
        self.last_swap_error = None

    # ---------------------------------------------------------- frontend --
    def submit(self, request):
        """Enqueue; O(1), thread-safe, fast-fails on backpressure."""
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "scheduler is draining/closed; not accepting requests")
            if len(self._queue) >= self.max_queue_size:
                _counters["requests_rejected"] += 1
                raise QueueFullError(
                    f"admission queue full ({self.max_queue_size} "
                    "requests); retry later")
            request.rid = next(self._rid)
            request.submit_ts = time.monotonic()
            if request.timeout_s is not None:
                request.deadline = request.submit_ts + request.timeout_s
            request.status = RequestStatus.QUEUED
            if request.trace_id is None and request.seed is not None:
                request.trace_id = _tracing.trace_id_for_seed(request.seed)
            self._queue.append(request)
            _counters["requests_submitted"] += 1
        _tracing.flight("submit", rid=request.rid, trace_id=request.trace_id,
                        prompt_len=len(request.prompt_ids))
        return request

    def has_work(self):
        return bool(self._queue or self._active or self._prefilling)

    def prefilling(self):
        return len(self._prefilling)

    def queued(self):
        return len(self._queue)

    def active(self):
        return len(self._active)

    def close(self):
        """Stop accepting; queued and in-flight requests drain. Lock-free
        on purpose: a signal handler may call it on a thread that already
        holds the lock inside submit()."""
        self._closed = True

    def cancel_pending(self, reason="server shutdown"):
        """Hard shutdown path: fail everything that has not finished."""
        self.close()
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            self._finish(req, RequestStatus.ERROR, error=reason)
        self.fail_all(reason)

    def fail_all(self, exc):
        """Engine fault escape hatch: fail in-flight work loudly instead of
        wedging callers blocked on result()."""
        for req in list(self._active.values()) \
                + list(self._prefilling.values()):
            self._finish(req, RequestStatus.ERROR, error=str(exc))

    def takeover_requests(self):
        """Replica-death path: hand back every queued and in-flight request
        unfinished. Their events stay unset, so callers blocked on
        ``result()`` keep waiting for the replay, and their tokens are
        cleared, so the replay regenerates them. Sampling depends only on
        (engine base key, request seed, token index), so a replica built
        with the same ``rng_seed`` reproduces each request whose seed was
        pinned. Call only after the driving thread has stopped."""
        self.close()
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
        inflight = list(self._active.values()) \
            + list(self._prefilling.values())
        self._active.clear()
        self._prefilling.clear()
        try:
            self.engine.reset()
        except Exception as e:  # a dead engine needs no slots back
            _explain.record("serving_takeover_reset_failed",
                            op="takeover_requests", error=repr(e))
        out = []
        for req in inflight + queued:
            if req.done:
                continue
            req.slot = None
            req.tokens = []
            req.first_tok_ts = req.last_tok_ts = None
            req.status = RequestStatus.QUEUED
            req.stop_reason = None
            req.error = None
            out.append(req)
        _counters["requeued_requests"] += len(out)
        return out

    # ----------------------------------------------------- weight swaps --
    def request_swap(self, state, source=None, draft_state=None):
        """Stage a weight swap; thread-safe, O(1). The driving thread
        applies it at the top of the next ``step()``, between two decode
        iterations, so no request sees a half-swapped model. A newer stage
        replaces one not applied yet. ``draft_state`` (spec-decode engines)
        swaps the drafter in the same commit."""
        with self._lock:
            self._pending_swap = (state, source, draft_state)

    def _apply_pending_swap(self):
        with self._lock:
            pending, self._pending_swap = self._pending_swap, None
        if pending is None:
            return
        state, source, draft_state = pending
        kw = {} if draft_state is None else {"draft_state": draft_state}
        try:
            self.engine.swap_weights(state, source=source, **kw)
        except Exception as e:
            # refused, or failed while staging: the engine writes nothing
            # before every weight is staged, so the old weights serve on
            _counters["swap_failures"] += 1
            self.last_swap_error = e
            _explain.record(
                "serving_swap_failed", op="swap_weights",
                why=f"weight swap{f' from {source}' if source else ''} "
                    f"failed ({type(e).__name__}: {e}); serving continues "
                    "on the pre-swap weights",
                source=source, error=str(e))
            return
        self.swap_count += 1
        self.last_swap_error = None

    # ---------------------------------------------------------- the loop --
    def step(self):
        """One continuous-batching iteration; returns True while any work
        remains. Single-threaded with respect to itself and the engine."""
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now

        # (0) a staged weight swap lands here, between decode iterations:
        # every token is computed on one consistent set of weights
        if self._pending_swap is not None:
            self._apply_pending_swap()

        if self._queue:
            # (1) deadline expired while queued: fail, never take a slot
            with self._lock:
                queued = list(self._queue)
            for req in queued:
                if req.deadline is not None and now > req.deadline:
                    with self._lock:
                        try:
                            self._queue.remove(req)
                        except ValueError:
                            continue
                    self._finish(req, RequestStatus.TIMEOUT)

            # (2) admission by KV block budget: a request leaves the queue
            # only when the pool can cover its worst case (a handoff: the
            # payload's blocks), so generation never runs out of cache
            # mid-flight; a head request that does not fit stays queued
            # (FIFO kept, backpressure at submit())
            while True:
                free = self.engine.free_slots()
                if not free:
                    break
                with self._lock:
                    head = self._queue[0] if self._queue else None
                if head is None:
                    break
                if head.kv_payload is not None:
                    fits = self.engine.can_import(head.kv_payload)
                else:
                    fits = self.engine.can_admit(head.prompt_ids,
                                                 head.max_new_tokens)
                if not fits:
                    _counters["pool_exhausted"] += 1
                    _explain.record(
                        "serving_pool_exhausted", op="admission",
                        why="KV block pool cannot cover the next queued "
                            "request even after prefix eviction; leaving "
                            "it queued until running requests release "
                            "blocks",
                        queued=len(self._queue))
                    break
                with self._lock:
                    req = self._queue.popleft() if self._queue else None
                if req is None:
                    break
                if not self._admit(req, free[0]):
                    break

        # (2b) chunked prefill: one chunk per mid-prefill slot, then the
        # decode iteration, so a long prompt costs in-flight streams one
        # chunk of latency per token instead of its whole prefill
        if self._prefilling:
            now = time.monotonic()
            for slot, req in list(self._prefilling.items()):
                if req.deadline is not None and now > req.deadline:
                    self._finish(req, RequestStatus.TIMEOUT)
                    continue
                try:
                    first = self.engine.prefill_chunk(slot)
                except Exception as e:
                    # the engine dropped the chunk state and its blocks
                    self._finish(req, RequestStatus.ERROR, error=str(e))
                    if not isinstance(e, (ValueError, TypeError)):
                        raise
                    continue
                if first is None:
                    continue
                self._prefilling.pop(slot, None)
                self._active[slot] = req
                now = time.monotonic()
                req.ttft_s = now - req.submit_ts
                _registry.timing("ttft", req.ttft_s, scope="serving")
                _registry.hist_record("ttft", req.ttft_s)
                self._append_token(req, first, now)

        # (3) one decode iteration over every active slot. A speculative
        # engine (decode_step_spec) emits 1..K+1 tokens per slot, each equal
        # to plain decode's; stop conditions apply per token in emission
        # order, and tokens after a stop are dropped
        if self._active:
            # one span per iteration while tracing is on, never per slot
            it0 = _tracing.clock() if _tracing.enabled() else 0.0
            spec = getattr(self.engine, "decode_step_spec", None)
            if spec is not None:
                per_slot = self._decode_with_retry(spec)
                now = time.monotonic()
                for slot, req in list(self._active.items()):
                    toks = per_slot[slot]
                    base = self.engine.slot_len(slot) - len(toks)
                    for i, t in enumerate(toks):
                        self._append_token(req, int(t), now,
                                           slot_len=base + i + 1)
                        if req.done:
                            break
            else:
                toks = self._decode_with_retry(self.engine.decode_step)
                now = time.monotonic()
                for slot, req in list(self._active.items()):
                    self._append_token(req, int(toks[slot]), now)
            if it0:
                _tracing.add_span(None, "decode_iter", it0, _tracing.clock())

        self._update_throughput()
        return self.has_work()

    def _decode_with_retry(self, step_fn):
        """One decode iteration, retried once: a transient engine error
        re-primes the engine (which recaptures its graphs and rebuilds the
        slot state from the host mirrors) and runs the iteration again;
        the second error in a row propagates, and the server loop then
        fails the batch. A ``FatalEngineError`` is never retried."""
        try:
            return step_fn()
        except FatalEngineError:
            raise
        except Exception as e:
            _counters["step_retries"] += 1
            _explain.record(
                "serving_step_retry", op="decode_step",
                why=f"transient decode failure ({type(e).__name__}: {e}); "
                    "re-priming the engine and retrying once before "
                    "failing the batch",
                error=str(e))
            self.engine.reprime()
            return step_fn()

    def drain(self, timeout=None):
        """Run step() until idle; True if fully drained."""
        self.close()
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.has_work():
            if deadline is not None and time.monotonic() > deadline:
                return False
            self.step()
        return True

    # ----------------------------------------------------------- helpers --
    def _admit(self, req, slot):
        """Admit ``req`` into ``slot``: adopt its handoff, else prefill it
        (chunked when long). Returns False when admission hit pool
        pressure and the request went back to the queue head (the caller
        stops admitting this step); True for every other outcome."""
        t_start = time.monotonic()
        handoff = req.kv_payload is not None
        chunked = (not handoff and self.prefill_chunk_tokens is not None
                   and len(req.prompt_ids) > self.prefill_chunk_tokens)
        opts = dict(temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p, seed=req.seed,
                    max_new_tokens=req.max_new_tokens)
        try:
            first = None
            if handoff:
                try:
                    first = self.engine.import_request_kv(
                        slot, req.kv_payload, prompt_ids=req.prompt_ids)
                except StaleHandoffError as e:
                    # a swap landed between the export and this admission:
                    # prefill here under the current weights, as a
                    # monolithic server that swapped first would have; the
                    # block budget is the same formula, so can_import's
                    # approval covers it
                    _explain.record(
                        "serving_handoff_stale", op="admission",
                        why=f"{e}; falling back to a fresh local prefill "
                            "on the current weights", rid=req.rid)
                req.kv_payload = None  # adopted or discarded
            if chunked:
                self.engine.begin_prefill(
                    slot, req.prompt_ids,
                    chunk_tokens=self.prefill_chunk_tokens, **opts)
            elif first is None:
                first = self.engine.prefill(slot, req.prompt_ids, **opts)
        except PagePoolExhausted:
            # can_admit's conservative budget makes this unreachable in
            # normal operation; the request goes back to the queue head
            _counters["pool_exhausted"] += 1
            with self._lock:
                self._queue.appendleft(req)
            return False
        except Exception as e:
            # the request left the queue but never became active, so fail
            # it here; bad-request errors stop there, anything else is an
            # engine fault and re-raises to the server loop
            self._finish(req, RequestStatus.ERROR, error=str(e))
            if not isinstance(e, (ValueError, TypeError)):
                raise
            return True
        req.slot = slot
        req.status = RequestStatus.RUNNING
        wait = t_start - req.submit_ts
        _registry.timing("queue_wait", wait, scope="serving")
        _registry.hist_record("queue_wait", wait)
        _tracing.add_span(req.trace_id, "queue_wait", req.submit_ts, t_start)
        if chunked:
            self._prefilling[slot] = req
            _tracing.flight("admit_chunked", rid=req.rid,
                            trace_id=req.trace_id, slot=slot)
            return True
        self._active[slot] = req
        now = time.monotonic()
        req.ttft_s = now - req.submit_ts
        _registry.timing("ttft", req.ttft_s, scope="serving")
        _registry.hist_record("ttft", req.ttft_s)
        _tracing.add_span(req.trace_id, "kv_adopt" if handoff else "admit",
                          t_start, now)
        _tracing.flight("admit", rid=req.rid, trace_id=req.trace_id,
                        slot=slot, handoff=handoff)
        self._append_token(req, first, now)
        return True

    def _append_token(self, req, token, now, slot_len=None):
        # slot_len: the sequence length as of this token. A speculative
        # round appends several tokens at once, with the engine's cursor
        # already past them; the length stop must see each token's own
        # position, as plain decode would have
        req.tokens.append(token)
        if req.last_tok_ts is not None:
            _registry.hist_record("inter_token", now - req.last_tok_ts)
        else:
            req.first_tok_ts = now
        req.last_tok_ts = now
        if slot_len is None and req.slot is not None:
            slot_len = self.engine.slot_len(req.slot)
        if req.eos_id is not None and token == req.eos_id:
            self._finish(req, RequestStatus.DONE, stop_reason="eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, RequestStatus.DONE, stop_reason="max_tokens")
        elif req.slot is not None and slot_len >= self.engine.max_seq_len:
            self._finish(req, RequestStatus.DONE, stop_reason="length")
        elif req.deadline is not None and now > req.deadline:
            self._finish(req, RequestStatus.TIMEOUT)

    def _finish(self, req, status, stop_reason=None, error=None):
        if req.slot is not None:
            self.engine.release(req.slot)
            self._active.pop(req.slot, None)
            self._prefilling.pop(req.slot, None)
            req.slot = None
        req.status = status
        req.stop_reason = stop_reason
        req.error = error
        if status == RequestStatus.DONE:
            _counters["requests_completed"] += 1
        elif status == RequestStatus.TIMEOUT:
            req.stop_reason = "deadline"
            _counters["requests_timeout"] += 1
        else:
            _counters["requests_failed"] += 1
        if req.first_tok_ts is not None and \
                req.last_tok_ts > req.first_tok_ts:
            _tracing.add_span(req.trace_id, "decode", req.first_tok_ts,
                              req.last_tok_ts)
        _tracing.flight("finish", rid=req.rid, trace_id=req.trace_id,
                        status=status, stop=req.stop_reason,
                        tokens=len(req.tokens))
        req.finished.set()

    def _update_throughput(self):
        dt = time.monotonic() - self._t0
        if dt > 0:
            _registry.gauge_set(
                "serving.tokens_per_sec",
                (_counters.get("tokens_generated", 0) - self._tok_base)
                / dt)
