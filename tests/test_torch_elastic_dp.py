"""A data-parallel world that breaks and forms again, on the CPU over gloo.

- ``tools/elastic_gpt_trainer.py --dp`` (``gpt2-tiny``) under the
  launcher: rank 1 is killed at step 5 and restarted on a fresh
  ``PADDLE_COORDINATOR``; rank 0's next collective fails, it restores the
  newest checkpoint in place and forms the world again on that
  coordinator. Every loss and every state after a step is bitwise the
  uninterrupted two-rank run's at its rank and step (the ranks' losses
  differ, their states agree: the gradients were averaged). Rank 1 killed
  again with its budget spent shrinks the world to one on a third
  coordinator, whose steps are bitwise a one-rank run resumed here from
  the same checkpoint.
- The world's group and ``DataParallel`` (no group given) follow a
  process group torn down and formed again at the same size.
- The fenced store barrier's ``abort`` predicate: an aborted wait returns
  None on the reference's keys (the JAX package's barrier completes it),
  and a wait that is never aborted still times out.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.distributed.fleet import elastic as JE  # noqa: E402
from paddle_tpu.distributed.store import TCPStore as JStore  # noqa: E402
from paddle_tpu_torch.distributed.fleet import elastic as E  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.incubate import checkpoint as ckpt  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = os.path.join(REPO, "tools", "elastic_gpt_trainer.py")
STEPS, VOCAB, SEQ = 11, 96, 32


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in [k for k in env if k.startswith("PADDLE_")] + [
            "FLAGS_fault_inject"]:
        env.pop(k, None)
    return env


def _leg(work, kill_at=""):
    os.makedirs(work)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--elastic", "--nproc_per_node", "2", "--max_restarts", "1",
           "--restart_backoff", "0.2", "--terminate_grace", "3",
           "--log_dir", os.path.join(work, "log"), TRAINER, "--work", work,
           "--dp", "--steps", str(STEPS), "--save-interval", "4",
           "--preset", "gpt2-tiny", "--seq-len", str(SEQ), "--vocab",
           str(VOCAB), "--device", "cpu"]
    if kill_at:
        cmd += ["--kill-at", kill_at]
    return subprocess.Popen(cmd, env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _events(p, work):
    from proc_utils import proc_timeout

    out, _ = p.communicate(timeout=proc_timeout(150))
    assert p.returncode == 0, out[-3000:]
    with open(os.path.join(work, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f], out


def _resumed_world_of_one(ckpt_dir):
    """A one-rank run resumed here from checkpoint 7 merged to world 1,
    on rank 0's batches: per step, its loss bits and state digest."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import elastic_gpt_trainer as trainer

    dev = torch.device("cpu")
    cfg, model, crit, opt = trainer.build("gpt2-tiny", 2, SEQ, VOCAB, dev,
                                          1e-4)
    state, man = ckpt.load_resharded(ckpt_dir, world_size=1, step=7)
    ckpt.restore_training_state(model, opt, state)
    step = trainer.step_of(model, crit, opt)
    out = {}
    for s in range(int(man["step"]) + 1, STEPS):
        loss = step(*trainer.batch_of(s, VOCAB, 2, SEQ, dev, shard=0))
        out[s] = (int(np.float32(loss.item()).view(np.uint32)),
                  trainer.state_digest(model, opt))
    return out


def test_dp_world_restarts_and_shrinks_bitwise(tmp_path):
    work_u, work_k = str(tmp_path / "u"), str(tmp_path / "k")
    u, k = _leg(work_u), _leg(work_k, kill_at="1:5,9")
    ev_u, _ = _events(u, work_u)
    ev, text = _events(k, work_k)
    want = {(e["rank"], e["step"]): (e["loss_bits"], e["digest"])
            for e in ev_u if e["ev"] == "step"}
    assert sorted(want) == [(r, s) for r in (0, 1) for s in range(STEPS)]
    batches = {(e["rank"], e["step"]): e["batch"] for e in ev_u
               if e["ev"] == "step"}
    for s in range(STEPS):
        assert batches[0, s] != batches[1, s], s  # batches of their own
        assert want[0, s][0] != want[1, s][0], s
        assert want[0, s][1] == want[1, s][1], s  # averaged gradients
    steps2 = [e for e in ev if e["ev"] == "step" and e["world"] == 2]
    assert {(e["rank"], e["step"]) for e in steps2} == set(
        (r, s) for r in (0, 1) for s in range(10))
    for e in steps2:
        assert (e["loss_bits"], e["digest"]) == want[e["rank"], e["step"]]
    assert "elastic resize 2 -> 1" in text, text[-2000:]

    starts = [e for e in ev if e["ev"] == "start"]
    restored = [e for e in ev if e["ev"] == "restored"]
    first, respawn, alone = (
        [e for e in starts if e["world"] == 2 and e["restart"] == 0],
        [e for e in starts if e["restart"] == 1],
        [e for e in starts if e["world"] == 1])
    assert len(first) == 2 and len(respawn) == 1 and len(alone) == 1
    assert len({e["coordinator"] for e in first}) == 1
    assert [(e["rank"], e["step"]) for e in restored] == [(0, 4)]
    assert respawn[0]["step"] == 4
    # the world formed again on the respawn's fresh coordinator, and the
    # world of one on another
    assert restored[0]["coordinator"] == respawn[0]["coordinator"]
    coords = [first[0]["coordinator"], respawn[0]["coordinator"],
              alone[0]["coordinator"]]
    assert len(set(coords)) == 3, coords
    assert alone[0]["step"] == 8 and alone[0]["epoch"] == 1

    got = {e["step"]: (e["loss_bits"], e["digest"]) for e in ev
           if e["ev"] == "step" and e["world"] == 1}
    assert got == _resumed_world_of_one(os.path.join(work_k, "ckpt"))


_REFORM = textwrap.dedent("""
    import json, os, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import collective, parallel_env
    from paddle_tpu_torch.distributed.parallel import DataParallel
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    lin = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(1.0)
    dp, out = None, []
    for port in sys.argv[1:]:
        os.environ["PADDLE_COORDINATOR"] = "127.0.0.1:" + port
        parallel_env.init_parallel_env(device="cpu", timeout=60)
        dp = dp or DataParallel(lin)
        lin.weight.grad = None
        dp(torch.full((1, 2), float(rank + 1))).sum().backward()
        out.append([lin.weight.grad.tolist(),
                    collective.get_group(0).process_group
                    is dist.group.WORLD,
                    dp.group.process_group is dist.group.WORLD])
        dist.destroy_process_group()
    print("OUT " + json.dumps(out))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def test_data_parallel_follows_a_world_formed_again(tmp_path):
    from proc_utils import proc_timeout

    script = tmp_path / "reform.py"
    script.write_text(_REFORM)
    ports = [_free_port(), _free_port()]
    procs = []
    for r in range(2):
        env = _env()
        env.update(PADDLE_TRAINER_ID=str(r), PADDLE_TRAINERS_NUM="2")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *ports], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=proc_timeout(90))
        assert p.returncode == 0, out[-2000:]
        got = json.loads(out.split("OUT ")[1])
        # (1 + 2) / 2 in each world, and the world's group and the
        # DataParallel's are the process group formed again, not the
        # destroyed one (whose connections lead to a dead sibling when a
        # world breaks)
        assert got == [[[[1.5, 1.5]], True, True]] * 2, got


@pytest.fixture()
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=10.0)
    yield s
    s.close()


def test_fence_barrier_abort_keeps_the_reference_keys(store):
    fence = E.GenerationFence(store, gen=0, rank=0)
    flag = threading.Event()
    threading.Timer(0.2, flag.set).start()
    assert fence.barrier("step3", 2, timeout=30, abort=flag.is_set) is None
    # the port's ack sits on the reference's key: the reference's rank 1
    # completes the same barrier at once
    peer = JE.GenerationFence(JStore("127.0.0.1", store.port), gen=0,
                              rank=1)
    assert peer.barrier("step3", 2, timeout=5) == 2
    assert int(store.add("elastic/barrier/0/step3", 0)) == 2
    ctx = E.ElasticTrainContext(store=store, rank=0, world=2, gen=0)
    assert ctx.barrier("step4", timeout=30, abort=lambda: True) is None
    with pytest.raises(TimeoutError):
        ctx.barrier("step5", timeout=0.2, abort=lambda: False)
