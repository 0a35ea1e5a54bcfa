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

The train→serve loop: ``swap_weights()`` stages a drain-free weight swap
that the worker applies between two decode steps (or while idle), and
``watch_checkpoints(dir)`` tails a training checkpoint directory
(``incubate.checkpoint``) and stages a swap whenever a newer valid
checkpoint commits (``CheckpointFollower``).
"""
from __future__ import annotations

import os
import threading
import time

from ..profiler import explainer as _explain
from .engine import FatalEngineError, GenerationEngine
from .scheduler import (ContinuousBatchScheduler, GenerationRequest,
                        RequestStatus)
from .spec_decode import DraftVerifyEngine


class CheckpointFollower:
    """One checkpoint-directory tail: the poll step of
    ``GenerationServer.watch_checkpoints``. A checkpoint is attempted once
    for each distinct (newest step, file set): a torn or partly written one
    is not re-read every tick, while a shard that lands later changes the
    file set and is attempted again. An attempt reads and checksums each
    payload once (``load_resharded``), and only checkpoints newer than the
    one being served.

    ``owner`` duck-types ``GenerationServer``: ``swap_weights(state,
    source)``, ``scheduler.swap_count`` / ``last_swap_error``, and a
    mutable ``last_swap_step``, which advances here only once a swap is
    applied: a refused swap does not report success."""

    def __init__(self, owner, ckpt_dir):
        self.owner = owner
        self.ckpt_dir = str(ckpt_dir)
        self._attempted = (-1, ())

    def poll(self, wait_applied=30.0, stop_event=None):
        """Check the directory once; when a newer valid checkpoint has
        committed, stage a weight swap and wait (bounded) for the worker
        to apply it. Returns the applied step, or None (no news, a torn
        payload, a refused swap, or still pending)."""
        from ..incubate import checkpoint as _ckpt

        last = self.owner.last_swap_step
        newer = [s for s in _ckpt.list_steps(self.ckpt_dir) if s > last]
        if not newer:
            return None  # no newer checkpoint directory: nothing to read
        d = os.path.join(self.ckpt_dir, f"ckpt-{newer[-1]:08d}")
        try:
            probe = (newer[-1], tuple(sorted(os.listdir(d))))
        except OSError:
            probe = (newer[-1], ())
        if probe == self._attempted:
            return None
        self._attempted = probe
        for step in reversed(newer):  # newest valid first, torn ones skipped
            state, man = _ckpt.load_resharded(self.ckpt_dir, world_size=1,
                                              step=step)
            if state is not None:
                break
        else:
            return None
        model_state = state.get("model", state) \
            if isinstance(state, dict) else state
        got = int(man["step"])
        sched = self.owner.scheduler
        c0, e0 = sched.swap_count, sched.last_swap_error
        self.owner.swap_weights(
            model_state, source=f"{self.ckpt_dir}/ckpt-{got:08d}")
        deadline = time.monotonic() + float(wait_applied)
        while time.monotonic() < deadline and not (
                stop_event is not None and stop_event.is_set()):
            if sched.swap_count > c0:
                self.owner.last_swap_step = got
                return got
            err = sched.last_swap_error
            if err is not None and err is not e0:
                return None  # refused; the explainer ring says why
            time.sleep(0.02)
        return None


class GenerationServer:
    """Serve a GPT model (or a prebuilt ``engine``). Engine options are
    those of ``GenerationEngine``; ``device=None`` runs on the current CUDA
    device and raises without one. ``draft_model`` (with ``draft_k``)
    serves through a ``DraftVerifyEngine``.

    ``fail_fast_on_fatal``: on a ``FatalEngineError`` the worker stops
    driving the engine and, when True, fails every pending request; a
    supervisor sets it False to take the requests over instead
    (``scheduler.takeover_requests``). Any other step error reaches the
    worker only after the scheduler's one retry, and fails the in-flight
    batch."""

    def __init__(self, model=None, engine=None, max_batch_size=4,
                 buckets=None, max_seq_len=None, max_queue_size=16,
                 idle_wait_s=0.005, fail_fast_on_fatal=True, block_size=16,
                 num_blocks=None, prefill_chunk_tokens=None,
                 paged_kernel=None, device=None, draft_model=None,
                 draft_k=4):
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
        self._fail_fast_on_fatal = bool(fail_fast_on_fatal)
        self._fatal = None
        # the checkpoint watcher
        self._watcher = None
        self._watch_stop = None
        self.last_swap_step = -1

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
                except FatalEngineError as e:
                    # the engine is dead: stop driving it. Standalone, fail
                    # the pending requests so result() callers don't wedge;
                    # under a supervisor, leave them for its takeover
                    self._fatal = e
                    self.scheduler.close()
                    _explain.record(
                        "serving_replica_fatal", op="serve_loop",
                        why=f"engine died fatally ({e}); worker loop "
                            "exiting", error=str(e))
                    if self._fail_fast_on_fatal:
                        self.scheduler.cancel_pending(
                            reason=f"fatal engine error: {e}")
                    break
                except Exception as e:  # fail loudly, don't wedge callers
                    self.last_error = e
                    _explain.record(
                        "serving_step_failed", op="serve_loop",
                        why=f"{type(e).__name__}: {e} (after one retry); "
                            "failing the in-flight batch", error=str(e))
                    self.scheduler.fail_all(e)
                continue
            if self._draining.is_set():
                break
            # idle: a staged swap applies here too, so following a
            # checkpoint directory does not wait for traffic
            self.scheduler._apply_pending_swap()
            with self._work:
                self._work.wait(self._idle_wait_s)

    @property
    def fatal_error(self):
        """The ``FatalEngineError`` that stopped the worker, or None."""
        return self._fatal

    def request_drain(self):
        """Graceful-drain trigger (sets flags only): the worker finishes
        all queued and in-flight requests, then exits."""
        self.scheduler.close()
        self._draining.set()

    # ------------------------------------------------- train→serve loop --
    def swap_weights(self, state, source=None):
        """Stage a drain-free weight hot-swap: thread-safe, returns at once.
        The worker applies it between two decode steps; in-flight requests
        keep their KV cache and finish on the new weights. A refused swap
        counts in ``serving.swap_failures`` (``serving_swap_failed``
        explainer record) and the old weights keep serving."""
        self.scheduler.request_swap(state, source=source)
        with self._work:
            self._work.notify()

    def watch_checkpoints(self, ckpt_dir, interval=0.5):
        """Tail a training checkpoint directory on a thread of its own,
        polling every ``interval`` seconds: whenever a newer valid
        checkpoint commits, merge its per-rank shards (any world size,
        ``incubate.checkpoint.load_resharded``) and stage a weight swap. A
        torn or partial checkpoint is skipped; the watcher waits for the
        next commit. Stops with ``stop_watcher()`` or ``shutdown()``."""
        if self._watcher is not None and self._watcher.is_alive():
            return self
        follower = CheckpointFollower(self, ckpt_dir)
        stop = self._watch_stop = threading.Event()

        def _tail():
            while not stop.is_set():
                try:
                    follower.poll(stop_event=stop)
                except Exception as e:  # the watcher must keep polling
                    _explain.record(
                        "serving_watcher_error", op="watch_checkpoints",
                        why=f"checkpoint watcher poll failed "
                            f"({type(e).__name__}: {e}); retrying next "
                            "interval", error=repr(e))
                stop.wait(float(interval))

        self._watcher = threading.Thread(
            target=_tail, daemon=True, name="paddle-tpu-torch-ckpt-watcher")
        self._watcher.start()
        return self

    def stop_watcher(self):
        if self._watch_stop is not None:
            self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=30)
            self._watcher = None

    def shutdown(self, drain=True, timeout=None):
        """Stop the server. ``drain=True`` finishes every queued and
        in-flight request first; ``drain=False`` fails them with
        status "error". Returns True if the worker exited in time."""
        self.stop_watcher()
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
