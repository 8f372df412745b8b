"""The port stands alone: no JAX, nothing of ``repro``; CUDA by default.

* An AST scan of every module of ``src/repro_torch`` (serving, ``optim``,
  ``core``, ``train``, ``data``) and of ``chip_smoke.py`` finds no import
  of ``jax`` or of the ``repro`` package.
* Every entry point runs on ``cuda`` unless asked for the CPU, and raises
  where there is no card (these tests skip on a machine that has one);
  every kernel wrapper runs its plain version for CPU tensors only.
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


def test_scan_covers_the_training_subpackages():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for p in PORT_FILES[:-1]}
    assert {"optim", "core", "train", "data", "kernels",
            "models"} <= scanned


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


def test_training_entry_points_default_to_cuda(no_card):
    """What a caller of ``make_ddp_steps`` builds its inputs with defaults
    to the card and raises here; a meta-device template sizes the steps
    without storage; the optimizer state follows the params' device."""
    from repro_torch.configs import get_config
    from repro_torch.convert import sgdm_state_from_jax
    from repro_torch.models import RunCtx, init_params
    from repro_torch.optim.optimizers import sgdm_init
    from repro_torch.train.ddp import make_ddp_steps
    cfg = get_config("qwen2-0.5b")
    assert RunCtx().device == "cuda"
    template = init_params(None, cfg, device="meta")
    _, _, k, n = make_ddp_steps(cfg, RunCtx(), None, None, 0.1, template)
    assert (k, n) == (49_403_276, 494_032_768)
    assert all(m.device.type == "meta"
               for m in _leaves(sgdm_init(template)["mom"]))
    small = cfg.reduced()
    tree = init_params(torch.Generator().manual_seed(0), small, device="cpu")
    as_numpy = {"mom": _tree_map(lambda t: t.numpy(), tree)}
    assert sgdm_state_from_jax(as_numpy, small, device="cpu")["mom"][
        "embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        sgdm_state_from_jax(as_numpy, small)


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_decode",
                                     "block_topk", "fused_sgdm",
                                     "scatter_aggregate"])
def test_kernel_wrappers_run_plain_only_on_cpu(wrapper):
    """Every kernel wrapper takes its plain version for CPU tensors only:
    a tensor elsewhere (here the meta device) gets an error, never the
    plain version."""
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import scatter_agg as sa
    x = torch.zeros((1, 8, 2, 32), device="meta")
    calls = {
        "flash_attention": lambda: fa.flash_attention(x, x, x),
        "flash_decode": lambda: fd.flash_decode(x[:, :1], x, x, 8),
        "block_topk": lambda: bt.block_topk(x.reshape(4, 128), 8),
        "fused_sgdm": lambda: bt.fused_sgdm(x, x, x, 0.1),
        "scatter_aggregate": lambda: sa.scatter_aggregate(
            x.reshape(2, 256), x.reshape(2, 256).int(), 10),
    }
    with pytest.raises(ValueError, match="device"):
        calls[wrapper]()


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """A kernel that cannot be built raises; nothing falls back."""
    from repro_torch.kernels import _build
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["flash_decode"])


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


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
