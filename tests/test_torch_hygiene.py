"""paddle_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_imports_with_jax_and_paddle_tpu_blocked():
    # a None entry in sys.modules makes any import of that name raise
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', "
            "'paddle_tpu.')) for k in sys.modules if sys.modules[k])\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")),
                                  REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_paddle_tpu_import_in_source(path):
    bad = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)(\.|\s|$)",
                     re.MULTILINE)
    assert not bad.search(path.read_text()), path


def test_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                             GPTModel)
    from paddle_tpu_torch.serving import GenerationEngine, GenerationServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.preset("gpt2-tiny", vocab_size=96)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPTModel(cfg)
    model = GPTForPretraining(GPTModel(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GenerationEngine(model)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GenerationServer(model)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device("cuda")
    # the training path: the model defaults to CUDA with or without a
    # requested attention route; the kernels' route refuses CPU tensors
    from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                      select_flash_kernel)

    train_cfg = GPTConfig.preset("gpt2-tiny", vocab_size=96, n_head=2,
                                 use_recompute=True)
    for kernel in (None, "cuda"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GPTModel(train_cfg, attn_kernel=kernel)
    with pytest.raises(ValueError, match="CUDA device"):
        GPTModel(train_cfg, device="cpu", attn_kernel="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        select_flash_kernel("cuda", device="cpu", head_dim=64,
                            dtype=torch.float32)
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, causal=True, kernel="cuda")


def test_kernel_choice_never_demotes_quietly():
    from paddle_tpu_torch.ops.paged_attention import select_paged_kernel

    kind, _ = select_paged_kernel(None, device="cpu", head_dim=32,
                                  dtype=torch.float32)
    assert kind == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        select_paged_kernel("cuda", device="cpu", head_dim=64,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="auto | cuda | torch"):
        select_paged_kernel("pallas", device="cpu", head_dim=64,
                            dtype=torch.float32)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    # no CUDA here: exit 2 and no result line, both in the checkout and
    # in a directory that holds chip_smoke.py alone
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 2, res.stderr
        assert '"ok"' not in res.stdout
