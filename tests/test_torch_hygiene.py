"""paddle_tpu_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""
import io
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite's parallel workers share the CPU, and
# a torch thread pool in each would oversubscribe it
torch.set_num_threads(1)

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


def test_encoder_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertModel, bert_base, bert_tiny,
                                         ernie_3p0_medium, ernie_tiny)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (bert_tiny, ernie_tiny, bert_base, ernie_3p0_medium,
                  lambda: BertModel(BertConfig.preset("bert-tiny"))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    model = BertForPretraining(bert_tiny(device="cpu", vocab_size=64))
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_static_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch import inference, jit, static

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        static.Executor()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        static.Executor("gpu:0")
    assert static.Executor("cpu").device.type == "cpu"
    assert static.Executor(static.cpu_places()[0]).device.type == "cpu"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        inference.create_predictor(inference.Config("model"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        static.load_inference_model("model")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        jit.load("model")


def test_cpu_artifact_is_refused_on_cuda(monkeypatch, tmp_path):
    """An artifact exported on the CPU holds flash_attention's plain route
    (baked in at export); every load of it on CUDA raises, naming the fix,
    instead of serving the plain attention on the card."""
    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention
    from paddle_tpu_torch.static.io import EXPORT_MAGIC

    torch.manual_seed(0)
    prefix = str(tmp_path / "mha")
    jit.save(MultiHeadAttention(64, 1), prefix,
             input_spec=[static.InputSpec([None, 128, 64], "float32")])
    blob = (tmp_path / "mha.pdmodel").read_bytes()[len(EXPORT_MAGIC):]
    exported = torch.export.load(io.BytesIO(blob))
    routes = [n.args[-1] for n in exported.graph.nodes
              if "flash_attention" in str(n.target)]
    assert routes == [False]  # the plain route, chosen on the CPU
    assert jit.load(prefix, device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for load in (lambda: jit.load(prefix),
                 lambda: static.load_inference_model(prefix),
                 lambda: inference.create_predictor(inference.Config(prefix))):
        with pytest.raises(ValueError, match="exported on cpu.*Export it "
                                             "again on cuda"):
            load()


def test_vision_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.vision import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("resnet50", "resnet18", "LeNet", "alexnet", "vgg11",
                 "squeezenet1_1", "mobilenet_v2", "shufflenet_v2_x0_25",
                 "googlenet", "inception_v3", "densenet121"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            getattr(models, name)()
    model = models.resnet18(num_classes=10, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {b.device.type for b in model.buffers()} == {"cpu"}


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


def test_init_parallel_env_raises_without_cuda_unless_asked_for_the_cpu(
        monkeypatch, tmp_path):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env

    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"backend": "gloo"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            init_parallel_env(**kw)
    assert not dist.is_initialized()
    # asked for the CPU: gloo, in a process of its own
    code = ("import torch.distributed as dist\n"
            "from paddle_tpu_torch.distributed import init_parallel_env, "
            "collective\n"
            f"init_parallel_env(device='cpu', init_method="
            f"'file://{tmp_path}/rdzv', timeout=30)\n"
            "print(dist.get_backend(), dist.get_world_size(), "
            "collective.get_group(0).nranks)\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), PADDLE_TRAINERS_NUM="1",
               PADDLE_TRAINER_ID="0")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["gloo", "1", "1"]


def test_dataloader_worker_entry_imports_no_torch():
    # the workers run io/_worker.py by path: it and the ring binding it
    # loads import the standard library and numpy, nothing of the package
    code = ("import runpy, sys\n"
            "g = runpy.run_path('paddle_tpu_torch/io/_worker.py')\n"
            "ring = g['_shm_ring_cls']()\n"
            "print(sorted(k for k in sys.modules if k == 'torch' or "
            "k.startswith(('torch.', 'paddle_tpu'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
