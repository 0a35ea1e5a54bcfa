#!/usr/bin/env python3
"""An elastic GPT trainer for ``paddle_tpu_torch.distributed.launch``.

    python -m paddle_tpu_torch.distributed.launch --elastic \\
        --nproc_per_node 2 tools/elastic_gpt_trainer.py --work DIR \\
        [--dp] [--steps 12] [--preset gpt3-1.3B] [--n-layer 2]
        [--seq-len 2048] [--batch 2] [--save-interval 3]
        [--step-deadline 0] [--kill-at RANK:K1,K2,...] [--device cuda|cpu]

The model is ``--preset`` at full width with ``--n-layer`` layers (bf16 on
the card, float32 on the CPU, random weights from seed 0) under
``AdamW(multi_precision=True)``. Two ways to train it:

- ``--dp``, data parallel: every rank joins the world's process group
  (``init_parallel_env(backend="gloo")``, from the launcher's
  ``PADDLE_COORDINATOR``), wraps the model in ``DataParallel`` and runs an
  eager step on a batch of its own (seeded by the step and the rank); the
  backward averages the gradients over the world, so every rank holds the
  same weights. A rank whose world broke (a collective raised, or the
  store's elastic generation moved because a sibling was restarted)
  destroys its process group, restores the newest checkpoint every rank
  committed, in place, and forms the world again on the coordinator the
  launcher published for the new generation
  (``elastic/coordinator/<gen>``), where the respawned sibling joins it.
  After a shrink the launcher starts the new world afresh on a new
  coordinator, and each rank keeps its batch of ``--batch`` sequences.
- without ``--dp``, replicas: every rank trains the same model on the same
  batch through ``jit.TrainStep`` (one CUDA graph on the card), and the
  world keeps in step through ``ElasticTrainContext.barrier`` (the fenced
  store barrier; ``TrainStep`` captures no gloo collective). A rank whose
  sibling was restarted restores the newest checkpoint in place and goes
  on: its captured graph stays valid.

``CheckpointHook(elastic=ElasticTrainContext(...), shard=True,
reshard=True)`` writes one sharded checkpoint every ``--save-interval``
steps (synchronously, so a rank's shard is on disk before its next step)
and handles preemption, the fence, and the fault points armed through
``FLAGS_fault_inject`` (first incarnation only, as a respawned rank must
not die again of the same fault). A rank that restores in place joins the
new generation's context (lease, preemption coordinator, watchdog).
``--kill-at 1:7,12`` arms ``kill_at_step`` on rank 1 at step 7 in its
first incarnation and at step 12 in its second. ``--step-deadline``
starts the step watchdog, which times each step and its boundary and not
the wait for the peers or a save.

Each rank appends JSON records to ``DIR/events.jsonl``: "start" (rank,
world, generation, world epoch, restart count, first step, the store's
and the coordinator's addresses, and the times at which the process
began, finished its imports, had its card ready, built its model,
restored its checkpoint and formed its world),
"step" (the loss's float32 bits; with ``--dp`` also digests of the
rank's batch and of the state after the step), "saved" (the save's seconds), "restored" (an
in-place restore: the seconds spent waiting for the new generation,
restoring and forming the world again, and with ``--dp`` the coordinator
it formed on; with no checkpoint yet the rank records "no_checkpoint" and
exits 3 instead, to be respawned afresh), "fenced", and at the end
"final" (the state's digest, the ``TrainStep`` captures, and K1-K3
launches counted on the card).
"""
from __future__ import annotations

import time

T_EXEC = time.time()  # before the heavy imports: a process start's cost

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

if int(os.environ.get("PADDLE_RESTART_COUNT", "0")) > 0:
    # a respawned rank must not die again of the fault that killed it
    os.environ.pop("FLAGS_fault_inject", None)


# seconds a rank waits for its peers: a barrier, a collective, the world
# forming again (a respawn's start and restore take ~35 s on the card)
WAIT_TIMEOUT = 300.0


def _parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", required=True)
    p.add_argument("--dp", action="store_true")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--preset", default="gpt3-1.3B")
    p.add_argument("--n-layer", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save-interval", type=int, default=3)
    p.add_argument("--step-deadline", type=float, default=0.0)
    p.add_argument("--kill-at", default="")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class Events:
    def __init__(self, work, rank):
        self.path = os.path.join(work, "events.jsonl")
        self.rank = rank

    def __call__(self, ev, **rec):
        rec = {"ev": ev, "rank": self.rank, "pid": os.getpid(),
               "t": time.time(), **rec}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def state_digest(model, opt):
    """A sha256 over the model's and the optimizer's state: per tensor, its
    name, dtype, shape and two sums of its bit patterns (plain, and
    weighted by position), taken where the tensor lives, so two states
    that differ in one bit differ here without copying gigabytes to the
    host."""
    import numpy as np
    import torch

    from paddle_tpu_torch.incubate.checkpoint import capture_training_state

    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha256()

    def walk(key, v):
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(f"{key}/{k}", v[k])
            return
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            t = v.detach().contiguous()
            bits = t.view(views[t.element_size()]).reshape(-1).long()
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            sums = torch.stack([bits.sum(), (bits * w).sum()]).tolist()
            h.update(f"{key}:{t.dtype}:{tuple(t.shape)}:{sums}".encode())
        else:
            h.update(f"{key}={v!r}".encode())

    walk("", capture_training_state(model, opt))
    return h.hexdigest()


def batch_of(step, vocab, batch, seq_len, device, shard=None):
    """Step ``step``'s tokens and labels: one batch for every replica
    (``shard`` None), or data-parallel rank ``shard``'s own."""
    import numpy as np
    import torch

    seed = 1000 + step if shard is None else (1000 + step, shard)
    toks = np.random.default_rng(seed).integers(0, vocab,
                                                (batch, seq_len + 1))
    return (torch.from_numpy(toks[:, :-1]).to(device),
            torch.from_numpy(toks[:, 1:]).to(device))


def build(preset, n_layer, seq_len, vocab, dev, lr):
    """The trainer's model (seed 0), its criterion and its optimizer."""
    import torch

    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    over = {"n_layer": n_layer}
    if vocab:
        over["vocab_size"] = vocab
    cfg = GPTConfig.preset(preset, seq_len=seq_len,
                           dtype="bfloat16" if dev.type == "cuda"
                           else "float32", dropout=0.0, **over)
    model = GPTForPretraining(GPTModel(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    opt = AdamW(learning_rate=lr, multi_precision=True,
                parameters=model.parameters())
    return cfg, model, GPTPretrainingCriterion(), opt


def step_of(net, crit, opt):
    """One training step of ``net`` (the model, or its ``DataParallel``)."""
    def step_fn(tokens, labels):
        loss = crit(net(tokens), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step_fn


def main(argv=None):
    args = _parse(argv)
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    log = Events(args.work, rank)

    import numpy as np
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet.elastic import (
        ElasticTrainContext, StaleGenerationError)
    from paddle_tpu_torch.distributed.parallel import (DataParallel,
                                                       broadcast_parameters)
    from paddle_tpu_torch.distributed.parallel_env import init_parallel_env
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.incubate.checkpoint import CheckpointHook
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.profiler import registry
    from paddle_tpu_torch.testing import faults

    t_imported = time.time()
    torch.set_num_threads(1)
    kills = args.kill_at.partition(":")
    if kills[2] and int(kills[0]) == rank:
        steps = [int(s) for s in kills[2].split(",")]
        if restart < len(steps):
            faults.configure(f"kill_at_step:step={steps[restart]},"
                             f"rank={rank}")
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        # ranks share the cards round-robin (all of them share one card
        # on a machine with one)
        local = int(os.environ.get("PADDLE_LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        from paddle_tpu_torch.ops import flash_attention as fa

        fa.reset_device_launches()
        torch.cuda.synchronize(dev)
    t_device = time.time()  # the card's context and the kernels loaded

    master = os.environ.get("PADDLE_MASTER", "")
    host, _, port = master.rpartition(":")
    store = TCPStore(host, int(port)) if port else None

    def generation():
        return int(store.add("elastic/gen", 0)) if store is not None else 0

    def join(gen):
        """This rank's elastic context for generation ``gen``."""
        return ElasticTrainContext(store=store, gen=gen,
                                   step_deadline=args.step_deadline or None,
                                   watchdog_sink=sys.stderr)

    gen = generation()
    ctx = join(gen)
    cfg, model, crit, opt = build(args.preset, args.n_layer, args.seq_len,
                                  args.vocab, dev, args.lr)
    t_built = time.time()
    hook = CheckpointHook(os.path.join(args.work, "ckpt"), model, opt,
                          save_interval=args.save_interval, max_to_keep=None,
                          async_save=False, rank=rank, world_size=world,
                          shard=True, reshard=True, elastic=ctx)
    step = hook.restore()
    t_restored = time.time()
    if args.dp:
        init_parallel_env(device=dev, backend="gloo",
                          timeout=WAIT_TIMEOUT)
        train = step_of(DataParallel(model), crit, opt)
    else:
        train = TrainStep(step_of(model, crit, opt), model, opt)
    ctx.start(first_step=step)
    log("start", world=world, gen=gen, epoch=ctx.fence.gen if ctx.fence
        else 0, restart=restart, step=step, master=master,
        coordinator=os.environ.get("PADDLE_COORDINATOR", ""),
        t_exec=T_EXEC, t_imported=t_imported, t_device=t_device,
        t_built=t_built,
        t_restored=t_restored, t_formed=time.time())

    def lockstep(s):
        """The replicas' barrier after step ``s``: False when a sibling
        was restarted meanwhile (the generation moved). The watchdog
        times this rank's own work, so it is disarmed while the rank
        waits for its peers (a hung peer trips its own) and armed again
        for step ``s``'s boundary."""
        if args.dp or ctx.fence is None or world == 1:
            return True
        wd = ctx.watchdog
        if wd is not None:
            wd.disarm()
        n = ctx.barrier(f"g{gen}.step{s}", timeout=WAIT_TIMEOUT,
                        abort=lambda: generation() != gen)
        if n is None:
            return False
        if wd is not None:
            wd.arm(s)
        return True

    def rejoin(why):
        """This rank's world broke (``why``): wait for the launcher's new
        generation, join it, restore the newest checkpoint in place and,
        with ``--dp``, form the world again on the generation's
        coordinator. Returns the step to run next."""
        nonlocal gen, ctx
        t0 = time.time()
        if args.dp and dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.monotonic() + WAIT_TIMEOUT
        while generation() == gen:
            if time.monotonic() > deadline:
                log("no_generation", step=step, gen=gen, why=why)
                sys.exit(4)
            time.sleep(0.02)
        gen = generation()
        ctx.stop()
        ctx = hook.elastic = join(gen)
        t1 = time.time()
        resumed = hook.restore()
        t2 = time.time()
        if resumed == 0 and step > 0:
            # nothing committed to go back to: start this rank afresh too
            # (the launcher respawns it)
            log("no_checkpoint", step=step, gen=gen, why=why)
            sys.exit(3)
        coord = None
        if args.dp:
            opt.clear_grad()  # a broken backward's partial gradients
            coord = store.get(f"elastic/coordinator/{gen}").decode()
            os.environ["PADDLE_COORDINATOR"] = coord
            init_parallel_env(device=dev, backend="gloo",
                              timeout=WAIT_TIMEOUT)
            # the respawned siblings' DataParallel broadcasts rank 0's
            # parameters: meet them
            broadcast_parameters(model, collective.get_group(0))
        ctx.start(first_step=resumed)
        t3 = time.time()
        log("restored", step=resumed, gen=gen, why=why, coordinator=coord,
            seconds=t3 - t0, wait_s=t1 - t0, restore_s=t2 - t1,
            form_s=t3 - t2)
        return resumed

    status = "ok"
    try:
        while step < args.steps:
            why = None
            if generation() != gen:
                why = "the generation moved"
            else:
                tokens, labels = batch_of(step, cfg.vocab_size, args.batch,
                                          args.seq_len, dev,
                                          shard=rank if args.dp else None)
                try:
                    loss = train(tokens, labels)
                    bits = np.float32(loss.float().item()).view(np.uint32)
                except StaleGenerationError:
                    raise
                except RuntimeError as e:
                    if not args.dp:
                        raise
                    why = f"a collective failed: {str(e)[:200]}"
                else:
                    rec = {"digest": state_digest(model, opt),
                           "batch": hashlib.sha256(tokens.cpu().numpy(
                           ).tobytes()).hexdigest()[:16]} if args.dp else {}
                    log("step", step=step, loss_bits=int(bits),
                        loss=float(loss.float().item()), gen=gen,
                        world=world, captures=registry.counters("jit")[
                            "train_step_captures"], **rec)
                    if not lockstep(step):
                        why = "the generation moved"
            if why is not None:
                step = rejoin(why)
                continue
            t0 = time.time()
            status = hook.on_step_end(step)
            if status == "saved":
                log("saved", step=step, seconds=time.time() - t0)
                ctx.step_boundary(step)  # the next step's deadline from here
            if status in ("preempted", "fenced"):
                log(status, step=step, seconds=time.time() - t0)
                break
            step += 1
    except StaleGenerationError as e:
        log("fenced", step=step, why=str(e))
        status = "fenced"
    ctx.stop()  # the watchdog times steps, not the summary below
    hook.wait()
    rec = {"world": world, "gen": gen, "step": step, "status": status,
           "digest": state_digest(model, opt),
           "jit": registry.counters("jit"),
           "fault": registry.counters("fault"),
           "timings": registry.timings("checkpoint")}
    if on_card:
        rec["flash_launches"] = {k: v for k, v in
                                 fa.device_launches().items()
                                 if k != "by_dtype"}
    log("final", **rec)
    hook.close()
    if args.dp and dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
