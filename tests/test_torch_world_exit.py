"""``testing.world.World`` leaves no semaphore behind: a two-rank world
started, used and closed in a child process, whose multiprocessing
resource tracker is then stopped (as ``chip_smoke.py``'s ``stop_children``
stops it), prints no "leaked semaphore" warning and no ``sem_unlink``
error."""
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_closed_world_leaks_no_semaphore(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from multiprocessing import resource_tracker
        from paddle_tpu_torch.testing.world import World

        world = World(2, {str(tmp_path)!r})
        assert world.run(abs, -3) == [3, 3]
        world.close()
        resource_tracker._resource_tracker._stop()
        print("done")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "done"
    assert "leaked semaphore" not in out.stderr, out.stderr[-2000:]
    assert "sem_unlink" not in out.stderr, out.stderr[-2000:]
