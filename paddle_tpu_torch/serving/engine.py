"""paddle_tpu_torch.serving.engine — paged-KV generation engine for decoders
(counterpart of paddle_tpu/serving/engine.py).

Continuous batching at the granularity of one decode iteration (Orca), over
a vLLM-style paged KV cache: per layer one fixed-shape block pool
``[num_blocks, block_size, heads, head_dim]`` addressed through per-slot
int32 block tables, plus a radix tree over block-aligned prompt chunks that
hands immutable prefix blocks to new requests by refcount
(``serving.prefix_hits`` / ``prefix_hit_tokens`` count the saved work).

* Prefill runs one request's prompt suffix (the part after its cached
  prefix), padded to a bucket length, through the masked gather path, and
  samples the first token at the prompt's last position. Each bucket has
  static input buffers and one body on them, captured into a CUDA graph at
  the bucket's first use (``serving.prefill_compiles`` counts captures;
  every bucket's graph, a spec drafter's too, draws on one shared memory
  pool) and replayed on the stream the decode graph replays on; on the
  CPU the body runs directly. The same graph serves a whole suffix, a prefix-hit remainder
  and one chunk of a chunked prefill: offset, length and table are data.
* The decode step runs every slot at ``[max_batch, 1]``: each slot's last
  token at its own position, its K/V row written through its block table,
  attention through the paged kernel chosen once per engine
  (``ops.paged_attention.select_paged_kernel``: "cuda" on the GPU, the
  plain "torch" version on the CPU). Inactive lanes compute garbage the
  host discards; their zeroed table rows aim every write at the reserved
  garbage block 0, so batch membership is data, not shape.

Decode fast path (the reference's jitted step with device-resident slot
state, ``paddle_tpu/serving/engine.py:85-96``): the slot state lives in
persistent device tensors (last tokens, cursors, keys, token indices,
sampling knobs, activity, block tables), and one step body reads them,
writes the tokens and float32 logits into static outputs, and advances
the cursors in place, masked by activity. On a CUDA device the body is
captured once per engine into a CUDA graph (``StepGraph``), so a steady
step is one graph replay and one device-to-host copy of the token block;
on the CPU the same body runs directly on the same buffers. Admission,
release, reset and the end of a chunked prefill mark the device state
stale; the next step copies the host mirrors into the same buffers (a
rebuild, ``fastpath.decode_rebuilds``) without recapturing. The host
mirrors advance in lockstep, and every ``_audit_every`` fast steps an
audit compares them with the device buffers and demotes the fast path on
a mismatch. A capture or replay error raises; there is no eager fallback.

The pools are updated in place; the reference's engine returned new pools
from pure jitted steps.

Weight hot-swap (``swap_weights``): every incoming weight is checked and
staged on the device before the first write, then copied into the live
parameters in place, so the captured graphs, which read fixed addresses,
serve the new weights with no recapture; the float32 LM-head copy of a
bf16 model is refreshed the same way. Each applied swap advances the
engine's weight generation (``weight_generation``). ``reprime`` drops the
captured decode graph after a step error (the prefill graphs stay): the
next step recaptures and rebuilds the slot state from the host mirrors,
which advance only after a step succeeds.

Prefill→decode handoff (disaggregated serving): ``export_request_kv``
gathers an active slot's KV blocks to host tensors with its decode state
and weight generation; ``import_request_kv`` on an engine with the same
model and block geometry scatters them into fresh blocks and installs the
slot, so its decode continues token for token as on the exporter. A
payload of another weight generation is refused (``StaleHandoffError``).
The generation counts swaps only: a re-prime changes no weight.

Observability: request spans (``prefill``, ``prefill_chunk``,
``kv_export``, ``kv_import``) and process spans (``swap_weights``) go to
``profiler.tracing`` while tracing is on; handoffs and swaps land in its
flight recorder. Fault points (``testing.faults``):
``page_pool_exhausted`` in ``can_admit``/``can_import``,
``kill_during_swap`` between a swap's staging and its first write, and
``slow_decode``, ``pod_slow``, ``replica_kill``, ``decode_error`` before
a decode step.

Tensor-parallel serving (``mesh=distributed.spmd.serving_mesh(mp)``, one
process per rank; the reference's ``engine.py:204-229``): where mp divides
the heads the model is cut to this rank's shard (``spmd.shard_model``),
each layer's pools hold the rank's ``H / mp`` heads, the paged kernel runs
on them unchanged (each head's softmax is whole on one rank, so the output
is the single-card kernel's on those heads, bit for bit), the row-parallel
layers all-reduce, and the vocabulary blocks of the LM head's logits are
gathered before sampling, in the decode and prefill bodies, so every rank
samples the same token. Where mp does not divide the heads, the model and
the pools stay whole on every rank. A handoff export gathers every rank's
heads (the payload is a single-card engine's); an import scatters them; a
swap takes a whole state and slices it (or a shard-shaped one). Rank 0
drives and the other ranks follow (``serving.mesh``). The step bodies are
CUDA graphs where the mp group's collectives can be captured (NCCL); over
gloo they run uncaptured (``stats()["decode_graph"]`` and its reason,
``serving.uncaptured_steps``). ``describe_sharding()`` gives the pools'
placement in the reference's schema; gauges ``serving.mesh.mp``,
``.paged_kernel`` and ``.paged_kernel_sharded``.

Slot lifecycle: free -> (admission: blocks allocated/shared, suffix
prefill, first token sampled) -> active (each decode step appends one row
at the slot's own cursor, always inside its own blocks) -> released
(blocks decref'd, table row zeroed). Drive it from one thread.
"""
from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from ..convert import _leaf, _linear_weight_names
from ..device import capture_lock, collector_paused, resolve_device
from ..distributed import collective
from ..distributed.spmd import ServingMesh, _axes, local_shard, shard_model
from ..ops.paged_attention import (_mesh_mp_degree, paged_sharded,
                                   select_paged_kernel)
from ..profiler import explainer as _explain
from ..profiler import registry as _registry
from ..profiler import tracing as _tracing
from ..testing import faults as _faults
from . import sampling as _sampling
from .block_pool import BlockPool, PagePoolExhausted, RadixPrefixCache
from .mesh import MeshLink, leader_call

_counters = _registry.scoped_counters("serving", {
    "prefills": 0, "decode_steps": 0, "tokens_generated": 0,
    "active_slot_steps": 0, "bucket_promotions": 0,
    "prefix_hits": 0, "prefix_misses": 0, "prefix_hit_tokens": 0,
    "prefix_inserted_blocks": 0, "prefix_evicted_blocks": 0,
    "kv_blocks_hwm": 0, "chunked_prefills": 0, "prefill_chunks": 0,
    "prefill_compiles": 0, "decode_compiles": 0, "weight_swaps": 0,
    "reprimes": 0, "handoff_exports": 0, "handoff_imports": 0,
    "handoff_stale": 0, "uncaptured_steps": 0})
# the decode fast path: steady steps on the device-resident slot state,
# rebuilds from the host mirrors at batch boundaries, audits of the two,
# and demotions after a failed audit (reference engine.py:94-96)
_fp_counters = _registry.scoped_counters("fastpath", {
    "decode_fast_steps": 0, "decode_rebuilds": 0, "decode_audit_runs": 0,
    "decode_demotions": 0})
_kernel_counters = _registry.scoped_counters("kernels")

# fast steps between two audits of the device slot state (the reference's
# AUDIT_EVERY, paddle_tpu/core/lazy.py:135)
AUDIT_EVERY = 16
# runs of a step body before its capture: the kernels' libraries load, their
# workspace sizes resolve and cuBLAS picks its kernels outside the graph
_CAPTURE_WARMUP = 3
_MASK32 = 0xFFFFFFFF


class WeightSwapError(RuntimeError):
    """A proposed weight swap does not fit the running engine (missing
    names, a shape mismatch, a value that is no number, or two weight
    layouts mixed). Raised before any weight is written: the engine keeps
    serving the old weights, and the KV cache is never touched."""


class StaleHandoffError(RuntimeError):
    """A handed-off KV payload was exported under another weight
    generation than the one this engine serves: adopting it would decode
    new weights over old-weight prompt KV. The scheduler answers it with a
    local prefill under the current weights."""


class FatalEngineError(RuntimeError):
    """Non-transient engine death (device lost). The scheduler's retry
    path never swallows it: it reaches the server loop, which stops
    driving the engine so a supervisor can take over its requests."""


def _refresh_head(gpt, head_w):
    """Copy ``gpt``'s embedding into its float32 LM-head weight ``head_w``
    where that is a separate tensor (a bf16 model); in float32 it is the
    weight itself."""
    wte = gpt.embeddings.word_embeddings.weight
    if head_w.data_ptr() != wte.data_ptr():
        with torch.no_grad():
            head_w.copy_(wte)


def _gather_vocab(logits, group):
    """``[rows, vocab]`` logits from each rank's vocabulary block
    ``[rows, vocab / mp]``: the blocks gathered over the mp ``group`` (rank
    order is vocabulary order); ``logits`` itself where ``group`` is None
    (a whole LM head)."""
    if group is None:
        return logits
    return collective.all_gather_axis(logits, group, tiled_dim=-1)


def _whole_shape(shape, shard):
    """The whole parameter's shape of a shard of ``shape`` cut by
    ``spmd.shard_model`` (``shard``: its ``mp_shard`` record), or
    ``shape`` itself where nothing was cut."""
    shape = tuple(shape)
    if shard is None:
        return shape
    dim, _, _, nranks = shard
    return shape[:dim] + (shape[dim] * nranks,) + shape[dim + 1:]


class StepGraph:
    """A step body that works on persistent buffers: captured once into a
    CUDA graph and replayed on a CUDA device, called directly on the CPU.

    ``capture()`` warms the body up on a side stream (the kernels' library
    loads, their workspace sizes resolve and cuBLAS picks its kernels),
    then records it; the caller first puts the buffers in a state whose
    writes are harmless, because the warm-up runs the body for real. Every
    allocation of the body then comes from the graph's private pool, and
    each replay runs on the current stream, after whatever eager work
    (prefill, buffer copies) was queued there before it.

    Launch accounting: a kernel wrapper bumps its ``kernels`` counter in
    Python, which under capture runs once and launches nothing. The
    counters that capture moved are put back and kept as the graph's
    launches per replay, and each replay adds them, so the counters still
    count launches. ``serving.<counter>`` counts captures
    (``decode_compiles`` for the decode graphs, ``prefill_compiles`` for
    the prefill buckets'). ``pool`` is a ``torch.cuda.graph_pool_handle()``
    shared with other graphs whose bodies keep nothing they allocate (None:
    a private pool).

    ``graph=False`` runs the body directly on a CUDA device too (an engine
    whose steps hold gloo collectives, which a graph cannot capture); each
    such call counts in ``serving.uncaptured_steps``. A capture, its
    warm-up included, holds ``device.capture_lock``: one at a time in a
    process."""

    def __init__(self, body, device, counter="decode_compiles", pool=None,
                 graph=True):
        self.body = body
        self._device = device
        self._counter = counter
        self._pool = pool
        self._graph = None
        self.graphed = device.type == "cuda" and bool(graph)
        self.launches = {}
        self.replays = 0

    @property
    def captured(self):
        return self._graph is not None

    def capture(self):
        with capture_lock:
            self._capture()

    def _capture(self):
        dev = self._device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_CAPTURE_WARMUP):
                self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(_kernel_counters)
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), \
                torch.cuda.graph(graph, pool=self._pool,
                                 capture_error_mode="thread_local"):
            self.body()
        self.launches = {k: v - before.get(k, 0)
                         for k, v in _kernel_counters.items()
                         if v != before.get(k, 0)}
        for k, n in self.launches.items():
            _kernel_counters[k] -= n
        self._graph = graph
        _counters[self._counter] += 1

    def __call__(self):
        if not self.graphed:
            self.body()
            if self._device.type == "cuda":
                _counters["uncaptured_steps"] += 1
            return
        self._graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            _kernel_counters[k] += n


class _PrefillBucket:
    """One prompt bucket's prefill: static input buffers (ids, positions,
    offset, length, table row, key, sampling knobs, and the index of the
    row that feeds the sample), the sampled token, and the body on them
    in a :class:`StepGraph`. The body is the reference's ``_prefill_pure``:
    the paged forward of ``gpt`` over the bucket through the masked
    gather path into the pools ``kv``, the pick of row ``end - 1 -
    start``, the float32 LM head ``head_w`` and the first sample (token
    index 0), its float32 logits kept in ``logits`` (the whole
    vocabulary: on a mesh, the ranks' blocks gathered). With ``head_w=None`` the body only writes K/V (the
    spec drafter's prefill, the reference's ``_draft_prefill_pure``).
    ``counter`` is the ``serving`` counter of its captures."""

    def __init__(self, engine, L, pool, gpt, kv, head_w,
                 counter="prefill_compiles"):
        dev = engine.device

        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._gpt, self._kv, self._head_w = gpt, kv, head_w
        self._vocab_group = engine._vocab_group
        self.ids = buf((1, L), torch.int64)
        self.positions = buf((1, L), torch.int64)
        self.offset = buf(1, torch.int32)
        self.length = buf(1, torch.int32)
        self.table = buf((1, engine.blocks_per_slot), torch.int32)
        self.key = buf((1, 2), torch.int64)
        self.temperature = buf(1, torch.float32)
        self.top_k = buf(1, torch.int64)
        self.top_p = buf(1, torch.float32)
        self.row = buf(1, torch.int64)
        self.token_idx = buf(1, torch.int64)
        self.token = buf(1, torch.int32)
        self.logits = None if head_w is None else buf(
            (1, engine.vocab_size), torch.float32)
        self.graph = StepGraph(self.body, dev, counter=counter, pool=pool,
                               graph=engine._graphs)

    def load(self, ids, positions, start, end, bt_row, key, temperature,
             top_k, top_p):
        """Copy one prefill's inputs into the buffers."""
        for b, a in ((self.ids, ids), (self.positions, positions),
                     (self.table, bt_row[None]), (self.key, key[None])):
            b.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        for b, v in ((self.offset, start), (self.length, end),
                     (self.temperature, temperature), (self.top_k, top_k),
                     (self.top_p, top_p), (self.row, end - 1 - start)):
            b.fill_(float(v) if b.is_floating_point() else int(v))

    def body(self):
        with torch.no_grad():
            hidden, _ = self._gpt(
                self.ids, position_ids=self.positions, caches=self._kv,
                cache_offsets=self.offset, seq_lens=self.length,
                block_tables=self.table)
            if self._head_w is None:
                return
            logits = _gather_vocab(hidden[0].index_select(0, self.row)
                                   .float() @ self._head_w.t(),
                                   self._vocab_group)
            gum = _sampling.gumbel_rows(self.key, self.token_idx,
                                        logits.shape[-1])
            self.logits.copy_(logits)
            self.token.copy_(_sampling.sample_tokens(
                logits, self.temperature, self.top_k, self.top_p, gum))


def _default_buckets(max_seq_len):
    """Powers-of-two ladder from 16 up to max_seq_len (always included)."""
    out = []
    b = 16
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return tuple(out)


class GenerationEngine:
    """Wraps a GPT decoder with a paged block-pool KV cache. The engine owns
    device compute, per-slot state and the block/prefix bookkeeping; request
    lifecycle lives in ``serving.scheduler``. Not thread-safe.

    ``device=None`` means the current CUDA device and raises without one;
    the model must already live on the engine's device. ``rng_seed`` pins
    the sampling base key (None draws it from torch's default generator).
    ``paged_kernel``: None/"auto", "cuda" or "torch" (see
    ``select_paged_kernel``).

    ``mesh``: a ``distributed.spmd.serving_mesh`` of ``mp`` ranks, one
    process each; every rank builds the engine with the same arguments
    (see ``serving.mesh``: rank 0 drives it, the others ``follow()``).
    Where mp divides the heads, the model is cut to this rank's shard
    (``spmd.shard_model``: its heads, its MLP columns, its vocabulary
    block), the pools hold its ``n_head / mp`` heads, the decode and
    verify steps run the paged kernel on them, and the vocabulary-sharded
    logits are gathered before sampling, so every rank samples the same
    token. Otherwise the model and the pools stay whole on every rank.
    The step bodies are captured into CUDA graphs where the mp group's
    collectives can be (NCCL); over gloo they run uncaptured
    (``stats()["decode_graph"]``)."""

    def __init__(self, model, max_batch_size=4, buckets=None,
                 max_seq_len=None, rng_seed=None, block_size=16,
                 num_blocks=None, paged_kernel=None, device=None,
                 mesh=None):
        gpt = getattr(model, "gpt", model)
        if not hasattr(gpt, "blocks") or not hasattr(gpt, "embeddings"):
            raise TypeError(
                "GenerationEngine needs a GPTModel-shaped decoder "
                "(blocks + embeddings + ln_f); got "
                f"{type(model).__name__}")
        self.device = resolve_device(device)
        if gpt.device != self.device:
            raise ValueError(
                f"the model lives on {gpt.device} but the engine runs on "
                f"{self.device}; build the model with device={self.device}")
        self._model = model
        self._gpt = gpt
        cfg = gpt.cfg
        self.vocab_size = int(cfg.vocab_size)
        self.max_seq_len = int(max_seq_len or cfg.seq_len)
        if self.max_seq_len > cfg.seq_len:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"position-embedding range {cfg.seq_len}")
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if buckets is None:
            buckets = _default_buckets(self.max_seq_len)
        self.buckets = tuple(sorted(
            {int(b) for b in buckets if 0 < int(b) <= self.max_seq_len}))
        if not self.buckets:
            raise ValueError(
                f"no usable prompt buckets in {buckets!r} "
                f"(need 0 < bucket <= max_seq_len={self.max_seq_len})")

        # paged-KV geometry: the pool defaults to capacity parity with a
        # contiguous layout (every slot can fill to max_seq_len) plus the
        # reserved garbage block
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.blocks_per_slot = -(-self.max_seq_len // self.block_size)
        if num_blocks is None:
            num_blocks = 1 + self.max_batch_size * self.blocks_per_slot
        self.pool = BlockPool(num_blocks)
        self.prefix_cache = RadixPrefixCache(self.pool, self.block_size)

        model.eval()
        # the tensor-parallel mesh: this rank's shard of the model where mp
        # divides the heads (every parameter annotated "mp" sliced in
        # place), else the whole model on every rank
        self._mesh = self._check_mesh(mesh)
        self._mp = _mesh_mp_degree(mesh)
        n_head = gpt.blocks[0].attn.n_head
        self._sharded = paged_sharded(mesh, n_head)
        if self._sharded:
            shard_model(model, mesh)
        self._link = MeshLink(mesh) if self._mp > 1 else None
        # the group the LM head's vocabulary blocks are gathered over (None:
        # the head is whole)
        self._vocab_group = gpt.embeddings.mp_group
        # the weights a swap replaces, by the decoder's own names (the
        # reference's names), and which of them are Linear weights: those
        # the reference stores [in, out]
        self._state = dict(gpt.state_dict(keep_vars=True))
        self._names = list(self._state)
        self._linear = _linear_weight_names(gpt)
        wte = gpt.embeddings.word_embeddings.weight
        self._dtype = wte.dtype
        # the LM head runs in float32, as in the reference; .float() is
        # the weight itself when the model is float32
        self._head_w = wte.detach().float()

        attn = gpt.blocks[0].attn
        self._paged_kernel, self._paged_kernel_reason = select_paged_kernel(
            paged_kernel, device=self.device, head_dim=attn.head_dim,
            dtype=self._dtype, mesh=mesh, num_heads=n_head)
        _explain.record("serving_paged_kernel", op="GenerationEngine",
                        why=self._paged_kernel_reason,
                        paged_kernel=self._paged_kernel)
        # the step bodies' route, decided here once: a CUDA graph per body,
        # unless a step holds collectives a graph cannot capture (gloo)
        self._graphs, self._graph_reason = self._graph_route(self._sharded)
        if mesh is not None:
            _registry.gauge_set("serving.mesh.mp", self._mp)
            _registry.gauge_set("serving.mesh.paged_kernel",
                                self._paged_kernel)
            _registry.gauge_set("serving.mesh.paged_kernel_sharded",
                                int(self._sharded))

        Nb, bs = self.pool.num_blocks, self.block_size
        self._kv = self._make_pools(gpt, Nb, bs, self._dtype)

        # host-side slot state, uploaded into each decode step
        B = self.max_batch_size
        self._active = np.zeros(B, bool)
        self._cur_lens = np.zeros(B, np.int32)
        self._last_tokens = np.zeros(B, np.int64)
        self._gen_idx = np.zeros(B, np.int64)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._top_ps = np.ones(B, np.float32)
        self._keys = np.zeros((B, 2), np.int64)
        # per-slot block tables (0 = reserved garbage block) and the ids
        # each slot holds a pool reference on
        self._block_tables = np.zeros((B, self.blocks_per_slot), np.int32)
        self._slot_blocks = [[] for _ in range(B)]
        # chunked prefill: slot -> in-progress admission state. Such a slot
        # is reserved: neither free nor active until its first token.
        self._mid_prefill: dict = {}
        # slot -> the trace id of the request it serves (None: untraced)
        self._slot_trace: dict = {}
        # weight swaps applied so far: the weight identity a handoff
        # payload carries and is checked against (a re-prime changes no
        # weight and leaves it alone)
        self._weight_gen = 0
        # bucket length -> _PrefillBucket, made at the bucket's first use;
        # every bucket's graph draws on one memory pool
        self._prefill_buckets: dict = {}
        self._prefill_pool = None

        # an explicit rng_seed pins every sampled token independently of
        # any global generator: two engines with the same rng_seed sample
        # identically
        if rng_seed is None:
            self._base_key = torch.randint(0, 1 << 32, (2,),
                                           dtype=torch.int64)
        else:
            s = int(rng_seed)
            self._base_key = torch.tensor([s & _MASK32, (s >> 32) & _MASK32],
                                          dtype=torch.int64)
        self._seed_counter = itertools.count()
        if self._link is not None:  # the leader's key is every rank's
            self._base_key = self._link.agree(
                type(self).__name__, self._signature(), self._base_key)

        # the decode fast path: device copies of the slot state above, the
        # step's static outputs, and the step body on them
        dev = self.device
        self._d_last = torch.zeros(B, dtype=torch.int64, device=dev)
        self._d_lens = torch.zeros(B, dtype=torch.int32, device=dev)
        self._d_keys = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        self._d_gen = torch.zeros(B, dtype=torch.int64, device=dev)
        self._d_temps = torch.zeros(B, dtype=torch.float32, device=dev)
        self._d_top_ks = torch.zeros(B, dtype=torch.int64, device=dev)
        self._d_top_ps = torch.ones(B, dtype=torch.float32, device=dev)
        self._d_active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._d_tables = torch.zeros((B, self.blocks_per_slot),
                                     dtype=torch.int32, device=dev)
        self._d_toks = torch.zeros(B, dtype=torch.int32, device=dev)
        self._d_logits = torch.zeros((B, self.vocab_size),
                                     dtype=torch.float32, device=dev)
        self._decode_graph = StepGraph(self._decode_body, dev,
                                       graph=self._graphs)
        # False after a batch boundary: the next step rebuilds the device
        # state from the host mirrors
        self._fast = False
        self._decode_since_audit = 0
        self._audit_every = AUDIT_EVERY
        # float32 [max_batch, vocab] logits of the latest decode step: the
        # step's static output buffer, valid until the next step
        self.last_logits = None
        # float32 [1, vocab] logits of the latest prefill's first sample:
        # its bucket's static buffer, valid until that bucket runs again
        self.last_prefill_logits = None

    # -------------------------------------------------------------- mesh --
    @staticmethod
    def _check_mesh(mesh):
        """A mesh whose only axis of more than one rank is "mp", built by
        ``spmd.serving_mesh`` when it has one."""
        if mesh is None:
            return None
        extra = {a: int(d) for a, d in _axes(mesh).items()
                 if a != "mp" and int(d) > 1}
        if extra:
            raise ValueError(
                f"a serving mesh has one axis, 'mp'; got extra axes {extra} "
                "(build it with distributed.spmd.serving_mesh)")
        if _mesh_mp_degree(mesh) > 1 and not isinstance(mesh, ServingMesh):
            raise TypeError(
                f"mesh {mesh!r}: build the serving mesh with "
                "distributed.spmd.serving_mesh (it carries the group the "
                "leader's calls reach the followers on)")
        return mesh

    def _graph_route(self, collectives):
        """``(capture the step bodies, why)`` for steps that do or do not
        hold the mesh's collectives."""
        if self.device.type != "cuda":
            return False, "cpu: the step bodies run directly"
        if collectives:
            backend = self._mesh.mp_group.backend
            if backend != "nccl":
                return False, (f"{backend} collectives cannot be captured")
        return True, "cuda graphs"

    def _make_pools(self, gpt, Nb, bs, dtype):
        """One ``(k, v)`` pool pair per layer, ``[Nb, bs, heads, Dh]`` at
        the heads this rank's shard of each layer holds."""
        return [tuple(torch.zeros((Nb, bs, self._local_heads(blk),
                                   blk.attn.head_dim),
                                  dtype=dtype, device=self.device)
                      for _ in range(2))
                for blk in gpt.blocks]

    @staticmethod
    def _local_heads(blk):
        return blk.attn.qkv_proj.weight.shape[0] // (3 * blk.attn.head_dim)

    def _signature(self):
        """What every rank of a mesh must build alike."""
        cfg = self._gpt.cfg
        return (type(self).__name__, self.max_batch_size, self.buckets,
                self.max_seq_len, self.block_size, self.pool.num_blocks,
                str(self._dtype),
                sorted((k, repr(v)) for k, v in vars(cfg).items()),
                self._paged_kernel)

    def follow(self):
        """A follower's loop (ranks other than 0 of a mesh): run the
        leader's calls, in its order, until it closes. Returns the number
        of calls run."""
        if self._link is None:
            raise RuntimeError("follow() is for the followers of an engine "
                               "on a serving mesh of more than one rank")
        return self._link.follow(self)

    def close(self):
        """Leader of a mesh engine: release the followers (their
        ``follow()`` returns); the engine takes no further calls. A no-op
        elsewhere."""
        if self._link is not None:
            self._link.close()

    # ------------------------------------------------------------- slots --
    def free_slots(self):
        return [i for i in range(self.max_batch_size)
                if not self._active[i] and i not in self._mid_prefill]

    def active_slots(self):
        return [i for i in range(self.max_batch_size) if self._active[i]]

    @leader_call
    def release(self, slot):
        """Evict a finished request: drop the slot's pool references and
        zero its table row. Shared prefix blocks stay alive through the
        radix tree's own reference. A mid-chunked-prefill slot releases its
        staged blocks the same way."""
        st = self._mid_prefill.pop(slot, None)
        if st is not None:
            self.pool.decref(st["table_ids"])
            self._note_pool()
        if self._slot_blocks[slot]:
            self.pool.decref(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._note_pool()
        self._block_tables[slot] = 0
        self._active[slot] = False
        self._cur_lens[slot] = 0
        self._gen_idx[slot] = 0
        self._slot_trace.pop(slot, None)
        self._fast = False  # slot membership changed: rebuild

    def slot_len(self, slot):
        return int(self._cur_lens[slot])

    @leader_call
    def reset(self):
        for i in range(self.max_batch_size):
            self.release(i)

    def bucket_for(self, prompt_len):
        """Smallest bucket holding the prompt; counts a promotion whenever
        the smallest bucket did not fit."""
        if prompt_len < 1:
            raise ValueError("prompt must contain at least one token")
        for b in self.buckets:
            if prompt_len <= b:
                if b != self.buckets[0]:
                    _counters["bucket_promotions"] += 1
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.buckets[-1]} (buckets={self.buckets})")

    # --------------------------------------------------- block budgeting --
    def _budget_rows(self, prompt_len, max_new_tokens):
        """Worst-case KV rows a request can ever write (prompt + token
        budget, capped by the cache ceiling). Allocated up front, so a
        request never runs out of blocks mid-flight."""
        if max_new_tokens is None:
            return self.max_seq_len
        return min(prompt_len + int(max_new_tokens), self.max_seq_len)

    def blocks_needed(self, prompt_len, max_new_tokens=None):
        b = self._budget_rows(prompt_len, max_new_tokens)
        return -(-b // self.block_size)

    def can_admit(self, prompt_ids, max_new_tokens=None):
        """Can the pool cover this request's worst case, counting cold
        prefix blocks as evictable? Ignores the prefix-hit discount, so True
        guarantees ``prefill`` cannot raise ``PagePoolExhausted``."""
        if _faults.ACTIVE and _faults.fire("page_pool_exhausted"):
            return False
        need = self.blocks_needed(len(prompt_ids), max_new_tokens)
        return need <= (self.pool.free_count()
                        + self.prefix_cache.evictable_count())

    def _evict(self, n):
        freed = self.prefix_cache.evict(n)
        if freed:
            _counters["prefix_evicted_blocks"] += freed
        return freed

    def _note_pool(self):
        used = self.pool.in_use()
        _registry.gauge_set("serving.kv_blocks_in_use", used)
        if used > _counters["kv_blocks_hwm"]:
            _counters["kv_blocks_hwm"] = used

    # ------------------------------------------------------------ prefill --
    def _check_prompt(self, slot, prompt_ids):
        if self._active[slot]:
            raise RuntimeError(f"slot {slot} is still active")
        if slot in self._mid_prefill:
            raise RuntimeError(f"slot {slot} has a prefill in progress")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must contain at least one token")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest bucket "
                f"{self.buckets[-1]} (buckets={self.buckets})")
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room to generate "
                f"(max_seq_len={self.max_seq_len})")
        vocab = self.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        return prompt

    def _admit_blocks(self, prompt, max_new_tokens):
        """Match and pin the longest cached block-aligned prefix (capped so
        the prompt's last token is always recomputed: its hidden state
        feeds the first sample) and allocate the rest of the worst-case
        budget. Returns (table_ids, bt_row, matched_prefix_len)."""
        bs = self.block_size
        matched = self.prefix_cache.match(prompt)
        matched = matched[:(len(prompt) - 1) // bs]
        P = len(matched) * bs
        need = self.blocks_needed(len(prompt), max_new_tokens) - len(matched)
        self.pool.incref(matched)  # pin before eviction can run
        try:
            fresh = self.pool.alloc(need, evict=self._evict)
        except PagePoolExhausted:
            self.pool.decref(matched)
            raise
        table_ids = matched + fresh
        bt_row = np.zeros(self.blocks_per_slot, np.int32)
        bt_row[:len(table_ids)] = table_ids
        return table_ids, bt_row, P

    @contextlib.contextmanager
    def _unwinding(self, table_ids):
        """Give an admission's blocks back if the block raises: a failed
        admission leaks nothing."""
        try:
            yield
        except Exception:
            self.pool.decref(table_ids)
            self._note_pool()
            raise

    def _prefill_graph_pool(self):
        """The memory pool every prefill graph of this engine draws on (the
        target's buckets and a spec drafter's); None on the CPU."""
        if self.device.type == "cuda" and self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        return self._prefill_pool

    def _prefill_bucket(self, L):
        """The bucket of length ``L``, made at its first use."""
        pb = self._prefill_buckets.get(L)
        if pb is None:
            pb = self._prefill_buckets[L] = _PrefillBucket(
                self, L, self._prefill_graph_pool(), self._gpt, self._kv,
                self._head_w)
        return pb

    def _run_prefill(self, pb, window, end, start, bt_row, key=None,
                     temperature=0.0, top_k=0, top_p=1.0, role="target"):
        """Load one prefill pass over prompt[start:end] (``window``), padded
        to the bucket ``pb``, and replay its graph. On a CUDA device the
        graph is captured at the bucket's first use, from the inputs just
        loaded: the capture's warm-up runs the body for real on them,
        writing the rows the replay then writes again with the same
        values."""
        L = pb.ids.shape[1]
        ids = np.zeros((1, L), np.int64)
        ids[0, :len(window)] = window
        positions = np.minimum(start + np.arange(L), self.max_seq_len - 1)
        if key is None:
            key = np.zeros(2, np.int64)
        pb.load(ids, positions[None], start, end, bt_row, key, temperature,
                top_k, top_p)
        if pb.graph.graphed and not pb.graph.captured:
            pb.graph.capture()
            _explain.record(
                "serving_prefill_compile", op="serving.prefill", role=role,
                why=f"first {role} prefill of bucket {L}: its graph was "
                    "captured; later prefills of this bucket replay it",
                detail=f"bucket_len={L}, max_batch={self.max_batch_size}")
        pb.graph()

    def _prefill_call(self, window, end, start, bt_row, key, temperature,
                      top_k, top_p):
        """One prefill pass over prompt[start:end], padded to its bucket,
        through the bucket's graph; the sample is taken at ``end - 1``
        (intermediate chunks discard it)."""
        pb = self._prefill_bucket(self.bucket_for(len(window)))
        with _registry.time_block("prefill", scope="serving"):
            self._run_prefill(pb, window, end, start, bt_row, key,
                              temperature, top_k, top_p)
            self.last_prefill_logits = pb.logits
            return int(pb.token.item())

    def _reserve_extra(self, slot, prompt, max_new_tokens):
        """Subclass hook (spec decode): reserve extra per-slot resources
        (the drafter's block budget) at admission. ``begin_prefill`` calls
        it, so a chunked admission holds its whole footprint from its
        start and a shortage surfaces as ``PagePoolExhausted`` there."""

    def _chunk_extra(self, slot, prompt, start, end):
        """Subclass hook (spec decode): extra work per prefill chunk (the
        drafter ingests the same window)."""

    def _install_extra(self, slot, prompt, max_new_tokens):
        """Subclass hook (spec decode): extra admission work run before the
        slot is installed. Raising here unwinds the admission."""

    def _install_slot(self, slot, prompt, table_ids, bt_row, tok, key,
                      temperature, top_k, top_p, matched_prefix,
                      max_new_tokens):
        with self._unwinding(table_ids):
            self._install_extra(slot, prompt, max_new_tokens)
        if matched_prefix:
            _counters["prefix_hits"] += 1
            _counters["prefix_hit_tokens"] += matched_prefix
        else:
            _counters["prefix_misses"] += 1
        bs = self.block_size
        full = len(prompt) // bs
        if full:
            created = self.prefix_cache.insert(prompt[:full * bs],
                                               table_ids[:full])
            _counters["prefix_inserted_blocks"] += created
        self._slot_blocks[slot] = table_ids
        self._block_tables[slot] = bt_row
        self._active[slot] = True
        self._cur_lens[slot] = len(prompt)
        self._last_tokens[slot] = tok
        self._gen_idx[slot] = 1
        self._temps[slot] = temperature
        self._top_ks[slot] = top_k
        self._top_ps[slot] = top_p
        self._keys[slot] = key
        self._fast = False  # admission is a batch boundary: rebuild
        self._note_pool()
        _counters["prefills"] += 1
        _counters["tokens_generated"] += 1

    def _request_key(self, seed):
        if seed is None:
            seed = next(self._seed_counter)
        return _sampling.request_key(self._base_key, seed).numpy()

    @leader_call
    def prefill(self, slot, prompt_ids, temperature=0.0, top_k=0,
                top_p=1.0, seed=None, max_new_tokens=None):
        """Admit a prompt into ``slot``: share its longest cached block
        prefix, allocate fresh blocks for the suffix and the generation
        budget, prefill the suffix, install the slot and publish the
        prompt's full blocks into the prefix cache. Returns the first
        generated token. Raises ``PagePoolExhausted`` when the pool cannot
        cover the request even after evicting cold prefixes."""
        prompt = self._check_prompt(slot, prompt_ids)
        trace = _tracing.trace_id_for_seed(seed) if seed is not None \
            else None
        table_ids, bt_row, P = self._admit_blocks(prompt, max_new_tokens)
        key = self._request_key(seed)
        with self._unwinding(table_ids), _tracing.span(trace, "prefill"):
            tok = self._prefill_call(prompt[P:], len(prompt), P, bt_row, key,
                                     temperature, top_k, top_p)
        self._install_slot(slot, prompt, table_ids, bt_row, tok, key,
                           temperature, top_k, top_p, P, max_new_tokens)
        self._slot_trace[slot] = trace
        return tok

    # -------------------------------------------------- chunked prefill --
    @leader_call
    def begin_prefill(self, slot, prompt_ids, temperature=0.0, top_k=0,
                      top_p=1.0, seed=None, max_new_tokens=None,
                      chunk_tokens=None):
        """Start a chunked admission: allocate the worst-case blocks up
        front (the same budget as ``prefill``), match the prefix cache, and
        leave the prompt to :meth:`prefill_chunk` in block-aligned chunks,
        so decode iterations interleave with a long prompt. Returns the
        number of pending chunks."""
        prompt = self._check_prompt(slot, prompt_ids)
        bs = self.block_size
        chunk = max(bs, (int(chunk_tokens or bs) // bs) * bs)
        table_ids, bt_row, P = self._admit_blocks(prompt, max_new_tokens)
        with self._unwinding(table_ids):
            self._reserve_extra(slot, prompt, max_new_tokens)
        self._mid_prefill[slot] = {
            "prompt": prompt, "done": P, "chunk": chunk,
            "table_ids": table_ids, "bt_row": bt_row,
            "key": self._request_key(seed), "temperature": temperature,
            "top_k": top_k, "top_p": top_p, "matched": P,
            "max_new_tokens": max_new_tokens,
            "trace": _tracing.trace_id_for_seed(seed)
            if seed is not None else None}
        self._note_pool()
        _counters["chunked_prefills"] += 1
        return -(-(len(prompt) - P) // chunk)

    @leader_call
    def prefill_chunk(self, slot):
        """Process the next chunk of a :meth:`begin_prefill` admission.
        Returns None while chunks remain; the final chunk samples the first
        token, installs the slot and returns that token. Earlier chunks are
        a longer prefix whose length is data, so a chunked prompt gives the
        tokens an unchunked one gives."""
        st = self._mid_prefill.pop(slot, None)
        if st is None:
            raise RuntimeError(f"slot {slot} has no prefill in progress")
        prompt, start = st["prompt"], st["done"]
        end = min(start + st["chunk"], len(prompt))
        # on a failure the admission ends here; reserved extras (drafter
        # blocks) come back when the scheduler releases the slot
        with self._unwinding(st["table_ids"]), \
                _tracing.span(st["trace"], "prefill_chunk"):
            tok = self._prefill_call(
                prompt[start:end], end, start, st["bt_row"], st["key"],
                st["temperature"], st["top_k"], st["top_p"])
            self._chunk_extra(slot, prompt, start, end)
        st["done"] = end
        _counters["prefill_chunks"] += 1
        if end < len(prompt):
            self._mid_prefill[slot] = st
            return None
        self._install_slot(
            slot, prompt, st["table_ids"], st["bt_row"], tok, st["key"],
            st["temperature"], st["top_k"], st["top_p"], st["matched"],
            st["max_new_tokens"])
        self._slot_trace[slot] = st["trace"]
        return tok

    # --------------------------------------------- prefill→decode handoff --
    @leader_call
    def export_request_kv(self, slot):
        """An active slot's paged-KV state for a handoff (disaggregated
        serving), as the reference's payload dict: the slot's blocks of
        every layer in block-table order as host tensors ``kv_k``/``kv_v``
        (``[n_blocks, block_size, heads, head_dim]`` in the pool's dtype,
        so bf16 bytes cross verbatim), with its decode state (cursor, last
        token, token index, request key, sampling knobs), the weight
        generation and the trace id. ``import_request_kv`` on an engine
        with the same model and block geometry continues the stream token
        for token: sampling depends only on (request key, token index).
        On a mesh every rank's heads are gathered, so the payload holds
        whole heads, as a single-card engine's does."""
        if not self._active[slot]:
            raise RuntimeError(f"slot {slot} is not active; nothing to "
                               "export")
        trace = self._slot_trace.get(slot)
        t0 = _tracing.clock() if _tracing.enabled() else 0.0
        ids = list(self._slot_blocks[slot])
        idx = torch.tensor(ids, dtype=torch.int64, device=self.device)
        # one gather on the device and one copy to the host
        kv = torch.stack([torch.stack((k.index_select(0, idx),
                                       v.index_select(0, idx)))
                          for k, v in self._kv])
        if self._sharded:  # [L, 2, n, bs, heads, Dh]: heads in rank order
            kv = collective.all_gather_axis(kv, self._mesh.mp_group,
                                            tiled_dim=4)
        kv = kv.cpu()
        _counters["handoff_exports"] += 1
        if t0:
            _tracing.add_span(trace, "kv_export", t0, _tracing.clock(),
                              meta={"bytes": kv.numel() * kv.element_size()})
        _tracing.flight("kv_export", trace_id=trace, slot=slot,
                        blocks=len(ids))
        return {
            "n_blocks": len(ids), "block_size": self.block_size,
            "kv_k": list(kv[:, 0].unbind(0)),
            "kv_v": list(kv[:, 1].unbind(0)),
            "cur_len": int(self._cur_lens[slot]),
            "last_token": int(self._last_tokens[slot]),
            "gen_idx": int(self._gen_idx[slot]),
            "key": self._keys[slot].copy(),
            "temperature": float(self._temps[slot]),
            "top_k": int(self._top_ks[slot]),
            "top_p": float(self._top_ps[slot]),
            "weight_generation": self._weight_gen,
            "trace": trace}

    def can_import(self, payload):
        """Admission budget of a handoff: can the pool cover the payload's
        blocks (the exporter allocated the request's worst case), counting
        cold prefix blocks as evictable? True guarantees
        ``import_request_kv`` cannot raise ``PagePoolExhausted``."""
        if _faults.ACTIVE and _faults.fire("page_pool_exhausted"):
            return False
        return int(payload["n_blocks"]) <= (
            self.pool.free_count() + self.prefix_cache.evictable_count())

    def _kv_blocks(self, a):
        """One layer's handed-off blocks on this engine's device in the
        pool's dtype: a host tensor as it is, an array (a reference
        payload) through numpy; on a head-sharded mesh, this rank's
        heads."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.require(_leaf(a), requirements="CW"))
        if self._sharded:
            h = self._kv[0][0].shape[2]
            a = a.narrow(2, self._mesh.rank * h, h).contiguous()
        return a.to(device=self.device, dtype=self._dtype)

    @leader_call
    def import_request_kv(self, slot, payload, prompt_ids=None):
        """Adopt a slot exported by :meth:`export_request_kv`: check the
        payload (weight generation, then block size, block count, layer
        count and block shape; ``StaleHandoffError`` or ``ValueError``
        with nothing allocated), allocate fresh blocks, scatter the
        handed-off rows into this engine's pools and install the slot.
        Returns the request's first token, sampled by the exporter. With
        ``prompt_ids`` the prompt's full blocks join this engine's prefix
        cache. A failed scatter gives its blocks back."""
        if self._active[slot] or slot in self._mid_prefill:
            raise RuntimeError(f"slot {slot} is not free")
        t0 = _tracing.clock() if _tracing.enabled() else 0.0
        gen = payload.get("weight_generation")
        if gen is not None and int(gen) != self._weight_gen:
            _counters["handoff_stale"] += 1
            raise StaleHandoffError(
                f"handoff exported under weight generation {gen}, this "
                f"engine serves generation {self._weight_gen}; re-prefill "
                "under the current weights instead of adopting stale KV")
        n = int(payload["n_blocks"])
        if int(payload["block_size"]) != self.block_size:
            raise ValueError(
                f"handoff block_size {payload['block_size']} != engine "
                f"block_size {self.block_size}: the engines must share one "
                "KV geometry")
        if n > self.blocks_per_slot:
            raise ValueError(f"handoff carries {n} blocks but a slot holds "
                             f"at most {self.blocks_per_slot}")
        if len(payload["kv_k"]) != len(self._kv) or \
                len(payload["kv_v"]) != len(self._kv):
            raise ValueError(
                f"handoff has {len(payload['kv_k'])} layers, engine has "
                f"{len(self._kv)}: a different model")
        for li, (kb, vb) in enumerate(zip(payload["kv_k"],
                                          payload["kv_v"])):
            k = self._kv[li][0]  # whole heads: every rank's
            want = (n, self.block_size,
                    k.shape[2] * (self._mp if self._sharded else 1),
                    k.shape[3])
            for got in (tuple(np.shape(kb)), tuple(np.shape(vb))):
                if got != want:
                    raise ValueError(f"handoff layer {li} blocks {got} != "
                                     f"engine {want}")
        fresh = self.pool.alloc(n, evict=self._evict)
        with self._unwinding(fresh):
            idx = torch.tensor(fresh, dtype=torch.int64, device=self.device)
            for (k, v), kb, vb in zip(self._kv, payload["kv_k"],
                                      payload["kv_v"]):
                k.index_copy_(0, idx, self._kv_blocks(kb))
                v.index_copy_(0, idx, self._kv_blocks(vb))
        bt_row = np.zeros(self.blocks_per_slot, np.int32)
        bt_row[:n] = fresh
        if prompt_ids is not None:
            prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
            full = min(len(prompt) // self.block_size, n)
            if full:
                created = self.prefix_cache.insert(
                    prompt[:full * self.block_size], fresh[:full])
                _counters["prefix_inserted_blocks"] += created
        trace = payload.get("trace")
        self._slot_trace[slot] = trace
        self._slot_blocks[slot] = fresh
        self._block_tables[slot] = bt_row
        self._active[slot] = True
        self._cur_lens[slot] = int(payload["cur_len"])
        self._last_tokens[slot] = int(payload["last_token"])
        self._gen_idx[slot] = int(payload["gen_idx"])
        self._temps[slot] = float(payload["temperature"])
        self._top_ks[slot] = int(payload["top_k"])
        self._top_ps[slot] = float(payload["top_p"])
        self._keys[slot] = np.asarray(payload["key"], np.int64)
        self._fast = False  # admission is a batch boundary: rebuild
        self._note_pool()
        _counters["handoff_imports"] += 1
        _counters["tokens_generated"] += 1  # the adopted first token
        if t0:
            nbytes = sum(int(np.prod(np.shape(a))) for a in
                         list(payload["kv_k"]) + list(payload["kv_v"])) \
                * self._kv[0][0].element_size()
            _tracing.add_span(trace, "kv_import", t0, _tracing.clock(),
                              meta={"bytes": nbytes})
        _tracing.flight("kv_import", trace_id=trace, slot=slot, blocks=n)
        return int(payload["last_token"])

    # ------------------------------------------------------------- decode --
    def _decode_body(self):
        """The decode step on the device slot state: every slot's last
        token at its own position, sampled into ``_d_toks`` with its float32
        logits in ``_d_logits``; the cursors of active slots advance in
        place. Decode semantics of the reference (``_decode_pure``):
        positions clamp to ``max_seq_len - 1``, ``seq_lens = cur_lens + 1``,
        ``q_offsets = positions``, the LM head runs in float32."""
        with torch.no_grad():
            lens = self._d_lens
            positions = lens.clamp(max=self.max_seq_len - 1)
            hidden, _ = self._gpt(
                self._d_last.unsqueeze(1),
                position_ids=positions.long().unsqueeze(1), caches=self._kv,
                cache_offsets=positions, seq_lens=lens + 1,
                block_tables=self._d_tables,
                paged_kernel=self._paged_kernel)
            logits = _gather_vocab(hidden[:, 0].float() @ self._head_w.t(),
                                   self._vocab_group)
            gum = _sampling.gumbel_rows(self._d_keys, self._d_gen,
                                        logits.shape[-1])
            toks = _sampling.sample_tokens(logits, self._d_temps,
                                           self._d_top_ks, self._d_top_ps,
                                           gum)
            self._d_logits.copy_(logits)
            self._d_toks.copy_(toks)
            active = self._d_active
            self._d_last.copy_(torch.where(active, toks.long(),
                                           self._d_last))
            lens.add_(active.int())
            self._d_gen.add_(active.long())

    def _mirrors(self):
        """(device buffer, host mirror) pairs of the slot state: what a
        rebuild copies and the audit compares."""
        return [(self._d_last, self._last_tokens),
                (self._d_lens, self._cur_lens), (self._d_keys, self._keys),
                (self._d_gen, self._gen_idx), (self._d_temps, self._temps),
                (self._d_top_ks, self._top_ks),
                (self._d_top_ps, self._top_ps),
                (self._d_active, self._active),
                (self._d_tables, self._block_tables)]

    def _prepare_fast(self, graphs):
        """Before a step: audit at its cadence, and after a batch boundary
        (or a failed audit) capture what is not captured yet and copy the
        host mirrors into the device buffers (a rebuild). Capture runs the
        bodies for real during warm-up, so it starts from an idle state:
        every slot inactive on the garbage block. (A spec engine's plain
        ``decode_step`` after its rounds finds its own graph uncaptured.)"""
        capture = self._graphs and not all(g.captured for g in graphs)
        if capture:
            self._fast = False
        if self._fast and self._decode_since_audit + 1 >= self._audit_every:
            self._audit_fast()
        if self._fast:
            self._decode_since_audit += 1
            _fp_counters["decode_fast_steps"] += 1
            return
        if capture:
            for buf, _ in self._mirrors():
                buf.zero_()
            for g in graphs:
                if not g.captured:
                    g.capture()
        for buf, host in self._mirrors():
            buf.copy_(torch.from_numpy(host))
        self._fast = True
        self._decode_since_audit = 0
        _fp_counters["decode_rebuilds"] += 1

    def _audit_fast(self):
        """The device slot state must equal the host mirrors bit for bit;
        a mismatch demotes the fast path (the next step rebuilds from the
        mirrors, which stay authoritative) with an explainer record."""
        _fp_counters["decode_audit_runs"] += 1
        self._decode_since_audit = 0
        if all(np.array_equal(buf.cpu().numpy(), host)
               for buf, host in self._mirrors()):
            return
        _fp_counters["decode_demotions"] += 1
        self._fast = False
        _explain.record(
            "fastpath_demoted", op="serving.decode", reason="decode_audit",
            why="decode audit: the device slot state diverged from the host "
                "mirrors; rebuilding from the host state")

    @staticmethod
    def _fire_decode_faults():
        """The decode-step fault points, before a step changes anything."""
        for point in ("slow_decode", "pod_slow", "replica_kill",
                      "decode_error"):
            _faults.fire(point)

    @leader_call
    def decode_step(self):
        """One continuous-batching iteration over all slots; returns the
        int32 ``[max_batch]`` token block (junk on inactive lanes) and
        advances every active slot's cursor and token index. A steady step
        is one replay of the captured body and one read of the token
        block; after a batch boundary the step first rebuilds the device
        state from the host mirrors."""
        active = self._active
        n_active = int(active.sum())
        if n_active == 0:
            raise RuntimeError("decode_step with no active slots")
        if _faults.ACTIVE and self._link is None:
            self._fire_decode_faults()
        with _registry.time_block("decode_step", scope="serving"):
            self._prepare_fast((self._decode_graph,))
            self._decode_graph()
            toks = self._d_toks.cpu().numpy()
        self.last_logits = self._d_logits
        self._finish_decode(active, n_active, toks)
        return toks

    def _finish_decode(self, active, n_active, toks):
        # host mirrors advance in lockstep with the device copies
        self._cur_lens[active] += 1
        self._gen_idx[active] += 1
        self._last_tokens[active] = toks[active]
        _counters["decode_steps"] += 1
        _counters["active_slot_steps"] += n_active
        _counters["tokens_generated"] += n_active
        _registry.gauge_set("serving.batch_occupancy",
                            n_active / self.max_batch_size)

    # ------------------------------------------------------- weight swap --
    def _resolve_swap_state(self, state, names=None):
        """Map an incoming state nest onto this engine's weight names (or
        an explicit ``names`` list: the spec-decode drafter reuses it on
        its own). Accepts the decoder's own state dict, a wrapper model's
        (one common name prefix, e.g. ``gpt.``), or a checkpoint nest
        ``{"model": ..., "optimizer": ...}`` (the optimizer part is
        ignored)."""
        names = self._names if names is None else names
        if not isinstance(state, dict):
            raise WeightSwapError(
                f"swap state must be a dict of name -> array, got "
                f"{type(state).__name__}")
        if isinstance(state.get("model"), dict) and "model" not in names:
            state = state["model"]
        if all(n in state for n in names):
            return {n: state[n] for n in names}
        probe = names[0]
        for key in state:
            if key.endswith(probe) and key != probe:
                pre = key[:-len(probe)]
                if all(pre + n in state for n in names):
                    return {n: state[pre + n] for n in names}
        missing = [n for n in names if n not in state]
        raise WeightSwapError(
            f"swap state is missing {len(missing)}/{len(names)} weights "
            f"(first: {missing[:3]}); a partial swap would serve "
            "inconsistent weights, refusing")

    def _stage_swap(self, resolved, names, bound, linear):
        """Check every value of a resolved swap against the live tensors
        ``bound``, then stage each on the device in its parameter's dtype.
        Returns the staged list, or raises with nothing written.

        The layout follows the value type, and one swap holds one type:
        torch tensors are in the port's layout (``model.state_dict()``);
        numpy arrays, tensor records and other array-likes are in the
        reference's, whose Linear weights (``linear``) are ``[in, out]``:
        they cross to the device as they are and are transposed there,
        which is much faster than on the host. Square Linear weights
        cannot be told apart by shape, so the layout is never guessed
        from it.

        On a mesh a parameter sliced to this rank's shard takes the whole
        weight, sliced here as ``spmd.shard_model`` slices it (a checkpoint
        need not know the layout), or a value already of the shard's
        shape; any other shape is refused."""
        torch_values = {isinstance(resolved[n], torch.Tensor) for n in names}
        if len(torch_values) > 1:
            raise WeightSwapError(
                "swap state mixes torch tensors (the port's [out, in] "
                "Linear layout) with arrays (the reference's [in, out] "
                "layout); pass one or the other")
        port_layout = torch_values == {True}
        checked = []  # (tensor as given, transpose it on the device)
        for n in names:
            cur, v = bound[n], resolved[n]
            if port_layout:
                t = v.detach()
                if t.dtype == torch.bool or t.is_complex():
                    raise WeightSwapError(
                        f"swap value for {n!r} has dtype {t.dtype}, which "
                        "does not cast to a floating-point weight")
            else:
                a = _leaf(v)
                if a.dtype.kind not in "fiu":
                    raise WeightSwapError(
                        f"swap value for {n!r} has dtype {a.dtype}, which "
                        "does not cast to a floating-point weight")
                t = torch.from_numpy(np.ascontiguousarray(a))
            flip = n in linear and not port_layout
            shape = tuple(t.shape)[::-1] if flip else tuple(t.shape)
            shard = getattr(cur, "mp_shard", None)
            whole = _whole_shape(cur.shape, shard)
            if shape != tuple(cur.shape) and shape == whole:
                dim, layout, rank, nranks = shard
                t = local_shard(t, t.dim() - 1 - dim if flip else dim, rank,
                                nranks, layout)
            elif shape != tuple(cur.shape):
                raise WeightSwapError(
                    f"shape mismatch for {n!r}: engine holds "
                    f"{tuple(cur.shape)}"
                    + (f" (its shard of {whole})" if shard else "")
                    + f", swap offers {shape}"
                    + (" after the [in, out] -> [out, in] transpose"
                       if flip else "") + " — this is a different model")
            checked.append((t, flip))
        staged = []
        for n, (t, flip) in zip(names, checked):
            t = t.to(device=self.device)
            staged.append((t.t() if flip else t).to(
                dtype=bound[n].dtype, memory_format=torch.contiguous_format))
        return staged

    @staticmethod
    def _commit_swap(names, bound, staged):
        with torch.no_grad():
            for n, t in zip(names, staged):
                bound[n].copy_(t)

    @leader_call
    def swap_weights(self, state, source=None):
        """Replace every weight between two steps, all or nothing. Call it
        on the engine's driving thread (``scheduler.request_swap`` and
        ``server.swap_weights`` are the thread-safe frontends).

        Every value is resolved, checked and staged on the device before
        the first write, so a refusal (missing name, shape mismatch, a
        mixed layout) raises ``WeightSwapError`` with the engine still
        serving the complete old weights. Then each staged tensor is
        copied into its live parameter in place, on the stream the decode
        graph replays on, so the graph replays the new weights with no
        recapture (``serving.decode_compiles`` stays put); the float32
        LM-head copy of a bf16 model is refreshed in place too. In-flight
        requests keep their KV cache and decode their next token on the
        new weights; the prefix cache moves to a new generation, since
        its blocks hold KV of the old weights, and the engine's weight
        generation advances."""
        t0 = time.perf_counter()
        tt0 = _tracing.clock() if _tracing.enabled() else 0.0
        resolved = self._resolve_swap_state(state)
        staged = self._stage_swap(resolved, self._names, self._state,
                                  self._linear)
        if _faults.ACTIVE and self._link is None:
            _faults.fire("kill_during_swap")
        t1 = time.perf_counter()
        self._commit_swap(self._names, self._state, staged)
        _refresh_head(self._gpt, self._head_w)
        if self.device.type == "cuda":  # swap_commit times the copies
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        _registry.timing("swap_stage", t1 - t0, scope="serving")
        _registry.timing("swap_commit", t2 - t1, scope="serving")
        self._fast = False
        self._weight_gen += 1
        self.prefix_cache.new_generation()
        self._note_pool()
        _counters["weight_swaps"] += 1
        if tt0:
            _tracing.add_span(None, "swap_weights", tt0, _tracing.clock())
        _tracing.flight("swap_weights", weights=len(staged), source=source,
                        generation=self._weight_gen)
        _explain.record(
            "serving_weight_swap", op="swap_weights",
            why=f"swapped {len(staged)} weights"
                + (f" from {source}" if source else "")
                + " in place; in-flight requests keep their KV cache and "
                  "decode the next token on the new weights; the prefix "
                  "cache is flushed (old-weight KV is unreusable)",
            weights=len(staged), source=source,
            generation=self._weight_gen)

    @leader_call
    def reprime(self):
        """Transient-fault recovery: drop the captured decode graph, so the
        next step captures it anew (``serving.decode_compiles`` + 1 on the
        card), and mark the device slot state stale, so that step first
        rebuilds it from the host mirrors. A failed replay may have
        advanced the device cursors in place; the mirrors advance only
        after a step succeeds. The prefix cache is flushed too: a fault
        mid-step may have left cached blocks in an unknown state. The
        prefill graphs and the weight generation stay: no weight
        changed."""
        self._decode_graph = StepGraph(self._decode_body, self.device,
                                       graph=self._graphs)
        self._fast = False
        self.prefix_cache.new_generation()
        self._note_pool()
        _counters["reprimes"] += 1

    # -------------------------------------------------------------- stats --
    @property
    def paged_kernel(self):
        """The decode attention path: "cuda" or "torch". Fixed at build."""
        return self._paged_kernel

    def mean_occupancy(self):
        steps = _counters["decode_steps"]
        if not steps:
            return 0.0
        return _counters["active_slot_steps"] / (
            steps * self.max_batch_size)

    def prefix_hit_rate(self):
        hits = _counters["prefix_hits"]
        total = hits + _counters["prefix_misses"]
        return hits / total if total else 0.0

    def stats(self):
        out = {**_registry.counters("serving"),
               "paged_kernel": self._paged_kernel,
               "paged_kernel_reason": self._paged_kernel_reason,
               "decode_graph": self._graphs,
               "decode_graph_reason": self._graph_reason,
               "mean_occupancy": self.mean_occupancy(),
               "prefix_hit_rate": self.prefix_hit_rate(),
               "kv_blocks_total": self.pool.usable_blocks,
               "kv_blocks_in_use": self.pool.in_use(),
               "kv_blocks_free": self.pool.free_count(),
               "prefix_cache_nodes": len(self.prefix_cache),
               "weight_generation": self._weight_gen,
               "prefix_generation": self.prefix_cache.generation}
        if self._mesh is not None:
            out["mesh_axes"] = {"mp": self._mp}
            out["paged_kernel_sharded"] = self._sharded
        return out

    def _pool_records(self, kv, sharded, **extra):
        """``describe_sharding``'s records of the pools ``kv``: shape and
        bytes of the pool across the mesh, its partition spec."""
        out = []
        for i, (k, v) in enumerate(kv):
            for name, a in (("k", k), ("v", v)):
                heads = a.shape[2] * (self._mp if sharded else 1)
                shape = [int(a.shape[0]), int(a.shape[1]), int(heads),
                         int(a.shape[3])]
                spec = None
                if self._mesh is not None:
                    spec = [None, None, "mp"] if sharded else []
                out.append({
                    "layer": i, "pool": name, **extra, "shape": shape,
                    "dtype": str(a.dtype).removeprefix("torch."),
                    "bytes": int(np.prod(shape)) * a.element_size(),
                    "spec": spec})
        return out

    def describe_sharding(self):
        """JSON-able placement of the engine's hot buffers, in the
        reference's schema (``tools/sharding_lint.py``'s ``lint_engine``
        reads it): the mesh's axes, the paged kernel, whether it runs per
        shard, and one record per per-layer KV pool with its shape and
        bytes across the mesh and its partition spec (``[None, None,
        "mp"]``: head-sharded; ``[]``: whole on every rank; None: no
        mesh)."""
        return {"mesh": None if self._mesh is None
                else {"axes": {"mp": self._mp}},
                "paged_kernel": self._paged_kernel,
                "paged_kernel_sharded": self._sharded,
                "kv_pools": self._pool_records(self._kv, self._sharded)}
