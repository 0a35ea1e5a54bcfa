"""paddle_tpu_torch.serving.server — threaded frontend over the batch
scheduler (counterpart of paddle_tpu/serving/server.py).

``GenerationServer`` owns the one thread that drives
``ContinuousBatchScheduler.step()``; the engine is not thread-safe.
Frontends use only thread-safe surfaces:

* ``submit()`` — enqueue and return a ``GenerationRequest`` at once; raises
  ``QueueFullError`` the instant the admission queue is full;
* ``result(req)`` / ``req.result()`` — block until the request is terminal;
* ``generate()`` — submit and wait, returning the token ids.

``shutdown()`` drains by default: it stops admitting, finishes every queued
and in-flight request, then stops the thread; ``shutdown(drain=False)``
fails pending work instead.
"""
from __future__ import annotations

import threading

from ..profiler import explainer as _explain
from .engine import GenerationEngine
from .scheduler import (ContinuousBatchScheduler, GenerationRequest,
                        RequestStatus)
from .spec_decode import DraftVerifyEngine


class GenerationServer:
    """Serve a GPT model (or a prebuilt ``engine``). Engine options are
    those of ``GenerationEngine``; ``device=None`` runs on the current CUDA
    device and raises without one. ``draft_model`` (with ``draft_k``)
    serves through a ``DraftVerifyEngine``."""

    def __init__(self, model=None, engine=None, max_batch_size=4,
                 buckets=None, max_seq_len=None, max_queue_size=16,
                 idle_wait_s=0.005, block_size=16, num_blocks=None,
                 prefill_chunk_tokens=None, paged_kernel=None, device=None,
                 draft_model=None, draft_k=4):
        if engine is None:
            if model is None:
                raise ValueError("GenerationServer needs a model or an "
                                 "engine")
            ekw = dict(max_batch_size=max_batch_size, buckets=buckets,
                       max_seq_len=max_seq_len, block_size=block_size,
                       num_blocks=num_blocks, paged_kernel=paged_kernel,
                       device=device)
            if draft_model is not None:
                # speculative decoding: the drafter proposes draft_k tokens
                # per iteration and the target verifies them in one forward
                engine = DraftVerifyEngine(model, draft_model,
                                           draft_k=draft_k, **ekw)
            else:
                engine = GenerationEngine(model, **ekw)
        self.engine = engine
        self.scheduler = ContinuousBatchScheduler(
            engine, max_queue_size=max_queue_size,
            prefill_chunk_tokens=prefill_chunk_tokens)
        self._idle_wait_s = float(idle_wait_s)
        self._work = threading.Condition()
        self._stop = threading.Event()      # hard stop at next boundary
        self._draining = threading.Event()  # graceful: finish, then stop
        self._thread = None
        self.last_error = None

    # ----------------------------------------------------------- control --
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._stop.is_set() or self._draining.is_set():
            raise RuntimeError("server was shut down; build a new one")
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-torch-serving", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            if self.scheduler.has_work():
                try:
                    self.scheduler.step()
                except Exception as e:  # fail loudly, don't wedge callers
                    self.last_error = e
                    _explain.record(
                        "serving_step_failed", op="serve_loop",
                        why=f"{type(e).__name__}: {e}; failing the "
                            "in-flight batch", error=str(e))
                    self.scheduler.fail_all(e)
                continue
            if self._draining.is_set():
                break
            with self._work:
                self._work.wait(self._idle_wait_s)

    def request_drain(self):
        """Graceful-drain trigger (sets flags only): the worker finishes
        all queued and in-flight requests, then exits."""
        self.scheduler.close()
        self._draining.set()

    def shutdown(self, drain=True, timeout=None):
        """Stop the server. ``drain=True`` finishes every queued and
        in-flight request first; ``drain=False`` fails them with
        status "error". Returns True if the worker exited in time."""
        if drain:
            self.request_drain()
        else:
            self._stop.set()
            self.scheduler.close()
        with self._work:
            self._work.notify_all()
        ok = True
        if self._thread is not None:
            self._thread.join(timeout)
            ok = not self._thread.is_alive()
        self._stop.set()
        if not drain:
            # only after the worker has exited: cancelling releases engine
            # slots, which must not race a decode step in flight
            self.scheduler.cancel_pending()
        return ok

    # ---------------------------------------------------------- frontend --
    def submit(self, prompt_ids, **options):
        """Enqueue a generation job; returns its ``GenerationRequest``.
        Raises ``QueueFullError`` under backpressure and ``RuntimeError``
        once shutdown has begun."""
        return self.submit_request(GenerationRequest(prompt_ids, **options))

    def submit_request(self, request):
        """Enqueue an existing ``GenerationRequest`` handle."""
        if self._draining.is_set() or self._stop.is_set():
            raise RuntimeError("server is shutting down; not accepting "
                               "requests")
        if self._thread is None:
            self.start()
        self.scheduler.submit(request)
        with self._work:
            self._work.notify()
        return request

    def result(self, request, timeout=None):
        return request.result(timeout)

    def generate(self, prompt_ids, result_timeout=None, **options):
        """Submit and wait; returns the generated token ids. Raises
        ``TimeoutError`` when the request's own deadline expired (partial
        tokens on the exception's ``.tokens``) and ``RuntimeError`` on
        failure."""
        req = self.submit(prompt_ids, **options).result(result_timeout)
        if req.status == RequestStatus.DONE:
            return list(req.tokens)
        if req.status == RequestStatus.TIMEOUT:
            err = TimeoutError(
                f"request {req.rid} hit its deadline after "
                f"{len(req.tokens)} tokens")
            err.tokens = list(req.tokens)
            raise err
        raise RuntimeError(f"request {req.rid} failed: {req.error}")
