"""The port stands alone: no module of gptq_for_llama_tpu_torch, and not
chip_smoke.py, imports jax or anything of the TPU package gptq_for_llama_tpu.
Kernel sources are built from the package's own csrc/ only."""

import ast
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gptq_for_llama_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "gptq_for_llama_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tpu_package_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_covers_the_four_kernels():
    """Named for the first slice's four kernels; the port now has all nine of
    the TPU package's (every function that reaches pl.pallas_call), one CUDA
    source each, every one naming the TPU kernel it replaces."""
    from gptq_for_llama_tpu_torch.ops import cuda
    from gptq_for_llama_tpu_torch.ops.cuda import build
    assert len(cuda.KERNELS) == 9 and set(cuda.KERNELS) == set(build.SOURCES)
    replaced = set()
    for name, kernel in cuda.KERNELS.items():
        assert kernel.source.endswith(f"csrc/{name}.cu"), kernel.source
        assert os.path.exists(os.path.join(ROOT, kernel.source)), kernel.source
        path, line = kernel.replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(line) - 1].startswith("def "), kernel.replaces
        replaced.add(kernel.replaces)
        assert isinstance(kernel.wrapper.launches, int)
    assert len(replaced) == 9
    cuda.reset_launch_counts()
    assert set(cuda.launch_counts().values()) == {0}


def test_new_modules_import_without_a_card():
    """The modules of the LoRA and fold paths import on a machine without a
    card or nvcc (kernels are built at first launch, never at import)."""
    import importlib
    for name in ("ops.lora", "ops.cuda.matmul_t", "engine.lora", "ops.quant_matmul",
                 "models.common", "runtime.graphs", "runtime.runner", "runtime.serve"):
        importlib.import_module(f"gptq_for_llama_tpu_torch.{name}")
    from gptq_for_llama_tpu_torch.engine import attach_lora, join_lora, split_lora  # noqa: F401


def test_build_raises_without_nvcc():
    from gptq_for_llama_tpu_torch.ops.cuda import build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build itself is checked on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
