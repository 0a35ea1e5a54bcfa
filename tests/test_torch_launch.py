"""The port's launcher (``paddle_tpu_torch.distributed.launch``) against the
JAX package's: the ``Pod``'s supervision (restart with backoff, the restart
cap, SIGTERM escalating to SIGKILL, shrink when a budget runs out, grow on
a resize request, lease expiry, a watchdog hang), ``ElasticManager``'s
kill-one-of-three resize, the command line across two nodes over gloo, a
world whose process group broke re-forming on the restart episode's own
coordinator, and the environment each launcher gives its children.

Trainers are stub scripts that import nothing heavy, except where a
process group is the point (the gloo worlds import torch).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

pytest.importorskip("jax")

from paddle_tpu.distributed.launch import main as jlaunch  # noqa: E402
from paddle_tpu_torch.distributed.fleet import elastic as E  # noqa: E402
from paddle_tpu_torch.distributed.launch.main import Pod  # noqa: E402
from paddle_tpu_torch.distributed.store import TCPStore  # noqa: E402
from paddle_tpu_torch.profiler import registry  # noqa: E402

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def store():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=1, timeout=10.0)
    yield s
    s.close()


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# ------------------------------------------------------- restart policy --

_FAIL_ONCE = textwrap.dedent("""
    import os, sys
    marker, log = os.environ["MARK"], os.environ["TLOG"]
    with open(log, "a") as f:
        f.write("start restart=%s\\n"
                % os.environ.get("PADDLE_RESTART_COUNT", "0"))
    if not os.path.exists(marker):
        open(marker, "w").close()
        sys.exit(int(os.environ.get("FAIL_RC", "3")))
    sys.exit(0)
""")


@pytest.mark.parametrize("rc", [3, E.HANG_RC], ids=["crash", "hang"])
def test_pod_restarts_failed_rank_with_backoff(tmp_path, rc):
    script = tmp_path / "t.py"
    script.write_text(_FAIL_ONCE)
    env = dict(os.environ, MARK=str(tmp_path / "m"),
               TLOG=str(tmp_path / "log"), FAIL_RC=str(rc))
    msgs = []
    pod = Pod(max_restarts=2, restart_backoff=0.1, log=msgs.append)
    t0 = time.time()
    pod.spawn([sys.executable, str(script)], env, str(tmp_path / "w.log"))
    assert pod.watch() == 0
    assert time.time() - t0 >= 0.1  # the backoff waited
    starts = (tmp_path / "log").read_text().splitlines()
    assert starts == ["start restart=0", "start restart=1"]
    if rc == E.HANG_RC:
        # the watchdog's exit reads as a hang, stacks in the worker log
        assert any("hung: step watchdog escalated" in m for m in msgs), msgs
    else:
        assert any("died" in m and "rc=3" in m for m in msgs), msgs


def test_pod_restart_cap(tmp_path):
    script = tmp_path / "t.py"
    script.write_text("import os, sys\n"
                      "open(os.environ['TLOG'], 'a').write('x')\n"
                      "sys.exit(5)\n")
    env = dict(os.environ, TLOG=str(tmp_path / "log"))
    msgs = []
    pod = Pod(max_restarts=1, restart_backoff=0.05, log=msgs.append)
    pod.spawn([sys.executable, str(script)], env, str(tmp_path / "w.log"))
    assert pod.watch() == 5
    assert (tmp_path / "log").read_text() == "xx"  # first run + 1 restart
    assert any("exhausted" in m for m in msgs), msgs


def test_pod_terminate_escalates_and_reaps(tmp_path):
    msgs = []
    ready = tmp_path / "ready"
    pod = Pod(terminate_grace=1.0, log=msgs.append)
    pod.spawn([sys.executable, "-c",
               "import signal, time;"
               "signal.signal(signal.SIGTERM, signal.SIG_IGN);"
               f"open({str(ready)!r}, 'w').close();"
               "time.sleep(60)"], dict(os.environ),
              str(tmp_path / "w.log"))
    deadline = time.time() + 30
    while not ready.exists() and time.time() < deadline:
        time.sleep(0.05)
    t0 = time.time()
    pod.terminate()
    assert time.time() - t0 < 8
    assert pod.procs[0].poll() == -signal.SIGKILL
    assert any("SIGKILL" in m for m in msgs), msgs


# ------------------------------------------------------- elastic resize --

_STUB_TRAINER = r"""
import os, sys, time
rank = os.environ["PADDLE_TRAINER_ID"]
world = os.environ["PADDLE_TRAINERS_NUM"]
gen = os.environ.get("PADDLE_ELASTIC_GEN", "0")
epoch = os.environ.get("PADDLE_WORLD_EPOCH", "0")
def log(line):
    with open(os.path.join(sys.argv[1], "ev.log"), "a") as f:
        f.write(line + "\n")
log(f"start rank={rank} world={world} gen={gen} epoch={epoch}")
mode = sys.argv[2]
if mode == "shrink":
    if rank == "2" and world == "3":
        sys.exit(9)  # this rank is lost for good at world 3
    for _ in range(15):
        time.sleep(0.1)
elif mode == "grow":
    if world != "3":
        time.sleep(60)  # hold until the supervisor resizes us away
elif mode == "sleep":
    time.sleep(60)
log(f"done rank={rank} world={world} gen={gen} epoch={epoch}")
"""


def _spawn_stub_world(pod, tmp_path, n, mode):
    trainer = tmp_path / "stub_trainer.py"
    trainer.write_text(_STUB_TRAINER)
    for r in range(n):
        env = dict(os.environ)
        env.update({"PADDLE_TRAINER_ID": str(r),
                    "PADDLE_TRAINERS_NUM": str(n),
                    "PADDLE_ELASTIC_GEN": "0"})
        pod.spawn([sys.executable, str(trainer), str(tmp_path), mode],
                  env, str(tmp_path / f"wl.{r}"))


def test_pod_shrinks_when_budget_exhausted(tmp_path, store):
    pod = Pod(max_restarts=1, restart_backoff=0.1, terminate_grace=1.0,
              store=store, elastic=True, log=lambda m: None)
    _spawn_stub_world(pod, tmp_path, 3, "shrink")
    before = registry.counters("fault")["elastic.resizes"]
    assert pod.watch() == 0
    ev = (tmp_path / "ev.log").read_text()
    starts2 = [ln for ln in ev.splitlines()
               if ln.startswith("start") and "world=2" in ln]
    assert len(starts2) == 2, ev
    # the resize moved both counters: gen (re-rendezvous) and the world
    # epoch (a membership change, which fences the old world)
    assert all("epoch=1" in ln and "gen=0" not in ln for ln in starts2)
    assert ev.count("done") == 2
    assert E.world_epoch(store) == 1
    assert registry.counters("fault")["elastic.resizes"] == before + 1


def test_pod_grows_on_resize_request(tmp_path, store):
    pod = Pod(max_restarts=2, restart_backoff=0.1, terminate_grace=1.0,
              store=store, elastic=True, log=lambda m: None)
    _spawn_stub_world(pod, tmp_path, 2, "grow")
    # filed after watch() begins: it ignores requests older than itself
    timer = threading.Timer(0.8, lambda: E.request_resize(store, 3))
    timer.start()
    assert pod.watch() == 0
    timer.join()
    ev = (tmp_path / "ev.log").read_text()
    done3 = [ln for ln in ev.splitlines()
             if ln.startswith("done") and "world=3" in ln]
    assert sorted(ln.split("rank=")[1].split()[0] for ln in done3) == \
        ["0", "1", "2"], ev


def test_pod_lease_expiry_declares_live_process_dead(tmp_path, store):
    pod = Pod(max_restarts=0, restart_backoff=0.1, terminate_grace=1.0,
              store=store, elastic=True, lease_ttl=0.4, lease_grace=0.6,
              log=lambda m: None)
    _spawn_stub_world(pod, tmp_path, 1, "sleep")
    # the rank registered once, then its heartbeat thread died
    store.set("elastic/lease/0/0", str(time.time() - 60.0))
    before = registry.counters("fault")["elastic.lease_expiries"]
    # a world of one cannot shrink: budget 0, the pod reports the kill
    assert pod.watch() == -signal.SIGKILL
    assert registry.counters("fault")["elastic.lease_expiries"] == \
        before + 1


_RESIZE_TRAINER = textwrap.dedent("""
    import os, pathlib, time
    ckpt = pathlib.Path(os.environ["ELASTIC_CKPT"])
    log = pathlib.Path(os.environ["ELASTIC_LOG"])
    world = os.environ["PADDLE_TRAINERS_NUM"]
    gen = os.environ.get("PADDLE_ELASTIC_GEN", "0")
    try:
        step = int(ckpt.read_text())
    except Exception:
        step = 0
    with log.open("a") as f:
        f.write(f"start gen={gen} world={world} step={step}\\n")
    tmp = ckpt.with_suffix(".tmp")
    while step < 80:
        step += 1
        loss = 1.0 / (1.0 + step)
        tmp.write_text(str(step)); tmp.replace(ckpt)
        with log.open("a") as f:
            f.write(f"step={step} loss={loss:.6f} world={world}\\n")
        time.sleep(0.08)
""")

_RESIZE_WRAPPER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, os.environ["REPO"])
    sys.modules["jax"] = None
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.store import TCPStore

    rank = int(sys.argv[1]); port = int(sys.argv[2])
    store = TCPStore("127.0.0.1", port, is_master=(rank == 0), world_size=3)
    m = ElasticManager(store=store, rank=rank, world_size=3,
                       heartbeat_interval=0.25, lease_ttl=3.0)
    env = dict(os.environ)
    env["ELASTIC_CKPT"] = os.environ["CKPT_DIR"] + f"/host{rank}.ckpt"
    env["ELASTIC_LOG"] = os.environ["CKPT_DIR"] + f"/host{rank}.log"
    status = m.run([sys.executable, os.environ["TRAINER"]], env=env,
                   max_restarts=3)
    print("STATUS", status, flush=True)
    sys.exit(0 if status == "completed" else 7)
""")


def test_kill_one_of_three_resumes_at_world_two(tmp_path):
    from proc_utils import proc_timeout

    trainer = tmp_path / "trainer.py"
    trainer.write_text(_RESIZE_TRAINER)
    wrapper = tmp_path / "wrapper.py"
    wrapper.write_text(_RESIZE_WRAPPER)
    port = _free_port()
    env = dict(os.environ, REPO=REPO, CKPT_DIR=str(tmp_path),
               TRAINER=str(trainer))
    procs = [subprocess.Popen([sys.executable, str(wrapper), str(r),
                               str(port)], env=env,
                              stdout=subprocess.PIPE, text=True)
             for r in range(3)]
    try:
        ckpt2 = tmp_path / "host2.ckpt"
        deadline = time.time() + proc_timeout(60)
        while time.time() < deadline:
            try:
                if ckpt2.exists() and int(ckpt2.read_text() or 0) >= 3:
                    break
            except ValueError:
                pass
            time.sleep(0.1)
        else:
            raise AssertionError("host 2's trainer never started")
        procs[2].send_signal(signal.SIGKILL)  # host 2 dies
        for r in (0, 1):
            rc = procs[r].wait(timeout=proc_timeout(60))
            out = procs[r].stdout.read()
            assert rc == 0 and "STATUS completed" in out, (r, rc, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
    for r in (0, 1):
        log = (tmp_path / f"host{r}.log").read_text().splitlines()
        starts = [ln for ln in log if ln.startswith("start")]
        assert "world=3" in starts[0]
        resized = [ln for ln in starts[1:] if "world=2" in ln]
        assert resized, f"host {r} never restarted at world 2: {starts}"
        assert int(resized[0].rsplit("step=", 1)[1]) > 0  # resumed
        losses = [float(ln.split("loss=")[1].split()[0])
                  for ln in log if ln.startswith("step=")]
        steps = [int(ln.split("step=")[1].split()[0])
                 for ln in log if ln.startswith("step=")]
        assert steps[-1] == 80
        assert all(b <= a + 1e-9 for a, b in zip(losses, losses[1:]))


# ----------------------------------------------- the command line, gloo --

_GLOO_TRAINER = textwrap.dedent("""
    import os, sys
    sys.modules["jax"] = None
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import init_parallel_env

    torch.set_num_threads(1)
    init_parallel_env(device="cpu", timeout=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == world and os.environ["PADDLE_CURRENT_ENDPOINT"] in eps
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    mark = os.environ.get("DIE_ONCE")
    if mark and rank == 1 and not os.path.exists(mark):
        open(mark, "w").close()
        os._exit(137)  # dies after one collective: the group is broken
    if mark:
        dist.all_reduce(x)  # the survivor's next collective fails
    print("RANK", rank, "OK", x.item(),
          "COORD", os.environ["PADDLE_COORDINATOR"],
          "RESTART", os.environ.get("PADDLE_RESTART_COUNT", "0"),
          flush=True)
    dist.destroy_process_group()
""")


def _launch_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _logs(d):
    return "\n".join(f"--- {p.relative_to(d)} ---\n" + p.read_text()
                     for p in sorted(d.rglob("workerlog.*")))


def test_two_node_world_allreduce(tmp_path):
    from proc_utils import proc_timeout

    script = tmp_path / "trainer.py"
    script.write_text(_GLOO_TRAINER)
    master = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", master, "--nnodes", "2", "--rank", str(rank),
         "--nproc_per_node", "1", "--max_restarts", "0",
         "--log_dir", str(tmp_path / f"log{rank}"), str(script)],
        env=_launch_env(), cwd=str(tmp_path)) for rank in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=proc_timeout(90)) == 0, _logs(tmp_path)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = _logs(tmp_path)
    # 1 + 2 over both nodes' trainers, and one coordinator for the world
    assert "RANK 0 OK 3.0" in logs and "RANK 1 OK 3.0" in logs, logs
    coords = {ln.split("COORD ")[1].split()[0] for ln in logs.splitlines()
              if ln.startswith("RANK")}
    assert len(coords) == 1, logs


def test_broken_world_reforms_on_a_fresh_coordinator(tmp_path):
    """Rank 1 dies after the world's first all_reduce; rank 0's next
    collective fails. Both are respawned on one coordinator that no dead
    world held, and the re-formed world all-reduces."""
    from proc_utils import proc_timeout

    script = tmp_path / "trainer.py"
    script.write_text(_GLOO_TRAINER)
    env = _launch_env()
    env["DIE_ONCE"] = str(tmp_path / "died")
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--max_restarts", "2",
         "--restart_backoff", "0.2", "--log_dir", str(tmp_path / "log"),
         str(script)], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=proc_timeout(120))
    logs = _logs(tmp_path)
    assert p.returncode == 0, (p.stderr[-2000:], logs)
    ok = [ln for ln in logs.splitlines() if ln.startswith("RANK")]
    assert sorted(ln.split()[1] for ln in ok) == ["0", "1"], logs
    # 1 + 2, twice: the re-formed world ran both collectives
    assert all(" OK 6.0 " in ln for ln in ok), logs
    coords = {ln.split("COORD ")[1].split()[0] for ln in ok}
    assert len(coords) == 1 and all(" RESTART 1" in ln for ln in ok), logs
    first = [ln for ln in p.stderr.splitlines() if "died" in ln]
    assert first, p.stderr


# ----------------------------------------------- environment parity ------

_ENV_DUMP = textwrap.dedent("""
    import json, os, sys
    with open(os.path.join(sys.argv[1],
              "env%s.json" % os.environ["PADDLE_LOCAL_RANK"]), "w") as f:
        json.dump(dict(os.environ), f)
""")


def test_children_get_the_reference_environment(tmp_path):
    from proc_utils import proc_timeout

    script = tmp_path / "dump.py"
    script.write_text(_ENV_DUMP)
    env = _launch_env()
    env["JAX_PLATFORMS"] = "cpu"
    procs = {}
    for pkg in ("paddle_tpu_torch", "paddle_tpu"):  # both at once
        out = tmp_path / pkg
        out.mkdir()
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.distributed.launch",
             "--nproc_per_node", "2", "--devices", "0,1",
             "--max_restarts", "0", "--log_dir", str(out / "log"),
             str(script), str(out)], env=env)
    envs = {}
    for pkg, p in procs.items():
        assert p.wait(timeout=proc_timeout(120)) == 0, pkg
        envs[pkg] = [json.load(open(tmp_path / pkg / f"env{r}.json"))
                     for r in (0, 1)]
    for mine, theirs in zip(envs["paddle_tpu_torch"], envs["paddle_tpu"]):
        keys = {k for k in theirs if k.startswith("PADDLE_")}
        assert {k for k in mine if k.startswith("PADDLE_")} == keys
        for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                  "PADDLE_MASTER", "PADDLE_LOCAL_RANK"):
            assert mine[k] == theirs[k], k
        for k in ("PADDLE_COORDINATOR", "PADDLE_CURRENT_ENDPOINT"):
            assert mine[k].startswith("127.0.0.1:"), k
        assert len(mine["PADDLE_TRAINER_ENDPOINTS"].split(",")) == 2
        # the card's device pin where the reference pins TPUs
        assert theirs["FLAGS_selected_tpus"] == "0,1"
        assert mine["FLAGS_selected_gpus"] == "0,1"
        assert mine["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert jlaunch.Pod.__init__.__code__.co_varnames[:10] == \
        Pod.__init__.__code__.co_varnames[:10]
