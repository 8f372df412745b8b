"""The port stands alone: no JAX, nothing of ``repro``; CUDA by default.

* An AST scan of every module of ``src/repro_torch`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or of the ``repro`` package.
* Every entry point runs on ``cuda`` unless asked for the CPU, and raises
  where there is no card (these tests skip on a machine that has one).
* The configs are the reference's, copied unchanged: every registered
  architecture gives equal fields and derived values in both packages.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(source: str):
    """Top-level package of every import in ``source``, including
    ``importlib.import_module("...")`` and ``__import__("...")``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_repro(path):
    bad = sorted(set(_imported_roots(path.read_text())) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.models import x\n"
           "import repro_torch\nimportlib.import_module('jaxlib.xla')\n")
    assert set(_imported_roots(src)) == {"jax", "repro", "repro_torch",
                                         "jaxlib"}


# ---------------------------------------------------------------------------
# CUDA unless asked for the CPU


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run there")


def test_launcher_defaults_to_cuda(no_card):
    from repro_torch.launch import serve
    assert serve.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--gen", "1", "--prompt-len", "4"])


def test_model_entry_points_default_to_cuda(no_card):
    from repro_torch.configs import get_config
    from repro_torch.models import RunCtx, init_cache, init_params
    cfg = get_config("qwen2-0.5b").reduced()
    assert RunCtx().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(None, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 8, RunCtx())


def test_convert_defaults_to_cuda(no_card):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import init_params
    cfg = get_config("qwen2-0.5b").reduced()
    tree = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    as_numpy = _tree_map(lambda t: t.numpy(), tree)
    assert params_from_jax(as_numpy, cfg, device="cpu")["embed"].shape == (
        cfg.padded_vocab_size, cfg.d_model)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(as_numpy, cfg)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """A kernel that cannot be built raises; nothing falls back."""
    from repro_torch.kernels import _build
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["flash_decode"])


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs copied unchanged


def _arch_ids():
    from repro_torch.configs.registry import _ARCH_MODULES
    return sorted(_ARCH_MODULES)


@pytest.mark.parametrize("arch", _arch_ids())
def test_configs_match_reference(arch):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for reduce in (False, True):
        jc, tc = jax_get_config(arch), get_config(arch)
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.pattern == jc.pattern
        assert tc.pattern_for_long_context() == jc.pattern_for_long_context()
        assert tc.padded_vocab_size == jc.padded_vocab_size
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.param_count() == jc.param_count()
        assert (tc.param_count(active_only=True)
                == jc.param_count(active_only=True))
