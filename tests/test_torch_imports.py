"""The port stands alone: no JAX, nothing of ``repro``; CUDA by default.

* An AST scan of every module of ``src/repro_torch`` (serving, ``optim``,
  ``core``, ``train``, ``data``, the serving runtime: ``serve``, ``sim``,
  ``obs``, ``core/streams.py``, ``models/paging.py``, and the trainer
  slice: ``core/scadles.py`` and its modules, ``fleet``, ``models/mlp.py``;
  the streamdata slice: ``streamdata``, ``models/cnn.py``,
  ``serve/control.py``; the training launcher slice: ``train/step.py``,
  ``checkpoint``, ``launch/train.py``, ``obs/profile.py``,
  ``obs/regress.py``; the training attention slice: ``launch/mesh.py``;
  the counting layer: ``dist/hlo_cost.py``, ``dist/hlo_analysis.py``,
  ``dist/calibrate.py``, ``launch/dryrun.py``, ``launch/sweep.py``)
  and of ``chip_smoke.py`` finds no import of ``jax`` or of the ``repro``
  package.  The same scan over the examples' counterparts,
  ``examples/*_torch.py``, also finds no import of ``benchmarks``.
* Every entry point runs on ``cuda`` unless asked for the CPU, and raises
  where there is no card (these tests skip on a machine that has one),
  but the counting layer's, which have no device (they record on fake CPU
  tensors: ``COUNTING_ENTRY_POINTS`` says why);
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
EXAMPLES = ("quickstart", "train_e2e", "serve_batched", "scadles_streaming",
            "fleet_churn")
EXAMPLE_FILES = sorted((ROOT / "examples").glob("*_torch.py"))


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


def test_scan_covers_the_serving_runtime():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    for sub in ("serve", "sim", "obs"):
        assert any(name.startswith(sub + "/") for name in scanned), sub
    assert {"core/streams.py", "models/paging.py", "serve/engine.py",
            "serve/scheduler.py", "obs/tracker.py"} <= scanned


def test_scan_covers_the_trainer_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"core/buffer.py", "core/simclock.py", "core/injection.py",
            "core/weighted_agg.py", "core/scadles.py", "models/mlp.py",
            "obs/mfu.py", "obs/callbacks.py", "fleet/__init__.py",
            "fleet/devices.py", "fleet/events.py", "fleet/policies.py",
            "fleet/engine.py", "fleet/control.py"} <= scanned


def test_scan_covers_the_moe_and_hybrid_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"models/moe.py", "models/rglru.py"} <= scanned


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_repro(path):
    bad = sorted(set(_imported_roots(path.read_text())) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_every_example_counterpart():
    assert [p.name for p in EXAMPLE_FILES] == sorted(
        f"{name}_torch.py" for name in EXAMPLES)
    for name in EXAMPLES:
        assert (ROOT / "examples" / f"{name}.py").exists(), name


@pytest.mark.parametrize("path", EXAMPLE_FILES,
                         ids=[p.name for p in EXAMPLE_FILES])
def test_example_counterparts_import_no_jax_repro_or_benchmarks(path):
    bad = sorted(set(_imported_roots(path.read_text()))
                 & set(FORBIDDEN + ("benchmarks",)))
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
                                     "flash_decode_paged", "block_topk",
                                     "fused_sgdm", "scatter_aggregate"])
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
        "flash_decode_paged": lambda: fd.flash_decode_paged(
            x[:, :1], x, x, torch.zeros((1, 2), dtype=torch.int32,
                                        device="meta"), 8),
        "block_topk": lambda: bt.block_topk(x.reshape(4, 128), 8),
        "fused_sgdm": lambda: bt.fused_sgdm(x, x, x, 0.1),
        "scatter_aggregate": lambda: sa.scatter_aggregate(
            x.reshape(2, 256), x.reshape(2, 256).int(), 10),
    }
    with pytest.raises(ValueError, match="device"):
        calls[wrapper]()


def test_serving_runtime_entry_points_default_to_cuda(no_card):
    """The paged cache, the slot runner, the cost model and the streaming
    launcher run on the card by default and raise here."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import RunCtx, init_paged_cache
    from repro_torch.serve import SlotRunner, measured_cost_model
    cfg = get_config("qwen2-0.5b").reduced()
    params = None                      # never reached: the device check
    with pytest.raises(RuntimeError, match="cuda"):
        init_paged_cache(cfg, 2, 16, RunCtx(), page_size=8, num_pages=4)
    with pytest.raises(RuntimeError, match="cuda"):
        SlotRunner(params, cfg, RunCtx(), 2, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        SlotRunner(params, cfg, RunCtx(), 2, 16, page_size=8, num_pages=4)
    with pytest.raises(RuntimeError, match="cuda"):
        measured_cost_model(params, cfg, RunCtx(), 2, 16, 8)
    args = serve.parse_args(["--streaming"])
    assert args.streaming and args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced", "--streaming", "--horizon", "0.5"])


def test_trainer_defaults_to_cuda(no_card):
    """``ScaDLESTrainer`` with a config that names no device runs on the
    card, and raises here before it builds anything; so does the edge
    MLP's ``init``."""
    from repro_torch.core import ScaDLESConfig, ScaDLESTrainer
    from repro_torch.data import ClassClusterData, DeviceDataSource
    from repro_torch.fleet import FleetConfig
    from repro_torch.models.mlp import make_mlp
    data = ClassClusterData(num_classes=10, train_per_class=4,
                            test_per_class=1, seed=0)
    src = DeviceDataSource(data, 2, iid=True)
    assert ScaDLESConfig().device == "cuda"
    for fleet in (None, FleetConfig(profile="jetson-mixed", policy="async")):
        with pytest.raises(RuntimeError, match="cuda"):
            ScaDLESTrainer(make_mlp(), src,
                           ScaDLESConfig(n_devices=2, fleet=fleet))
    with pytest.raises(RuntimeError, match="cuda"):
        make_mlp()["init"](torch.Generator().manual_seed(0))
    tr = ScaDLESTrainer(make_mlp(), src, ScaDLESConfig(n_devices=2, b_max=8,
                                                       device="cpu"))
    assert tr.params["w1"].device.type == "cpu"



def test_scan_covers_the_streamdata_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"streamdata/__init__.py", "streamdata/partition.py",
            "streamdata/generators.py", "streamdata/loader.py",
            "models/cnn.py", "serve/control.py"} <= scanned


def test_cnn_defaults_to_cuda(no_card):
    """``init_cnn`` and ``cnn_params_from_jax`` with no device run on the
    card, and raise here; ``device="meta"`` sizes the model without a
    card and ``device="cpu"`` must be asked for."""
    from repro_torch.configs import get_config
    from repro_torch.convert import cnn_params_from_jax
    from repro_torch.models import init_cnn
    cfg = get_config("paper-cnn")
    with pytest.raises(RuntimeError, match="cuda"):
        init_cnn(None, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cnn(torch.Generator().manual_seed(0), cfg)
    meta = init_cnn(None, cfg, device="meta")
    assert meta["fc2"]["w"].device.type == "meta"
    tree = init_cnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    as_numpy = _tree_map(lambda t: t.numpy(), tree)
    assert cnn_params_from_jax(as_numpy, cfg, device="cpu")["conv"][3][
        "w"].shape == (3, 3, 256, 256)
    with pytest.raises(RuntimeError, match="cuda"):
        cnn_params_from_jax(as_numpy, cfg)

def test_scan_covers_the_training_launcher_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"checkpoint/__init__.py", "checkpoint/ckpt.py",
            "launch/train.py", "obs/profile.py", "obs/regress.py",
            "train/step.py"} <= scanned


def test_training_launcher_slice_defaults_to_cuda(no_card, tmp_path):
    """The training launcher, ``restore_pytree`` and ``rglru.init_state``
    run on the card unless asked for the CPU, and raise here."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import rglru
    assert train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--batch", "2", "--seq",
                    "8"])
    save_pytree({"w": torch.ones(2)}, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        restore_pytree({"w": torch.empty(2, device="meta")}, str(tmp_path))
    assert torch.equal(restore_pytree({"w": torch.empty(2, device="meta")},
                                      str(tmp_path), device="cpu")["w"],
                       torch.ones(2))
    cfg = get_config("recurrentgemma-2b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        rglru.init_state(cfg, 2)
    h, conv = rglru.init_state(cfg, 2, dtype=torch.bfloat16, device="cpu")
    assert (h.dtype, conv.dtype, conv.shape[1]) == (torch.float32,
                                                    torch.bfloat16, 3)


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
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


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


def test_scan_covers_the_counting_layer():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"dist/hlo_cost.py", "dist/hlo_analysis.py", "dist/calibrate.py",
            "launch/dryrun.py", "launch/sweep.py", "obs/mfu.py"} <= scanned


# Exempt from the CUDA-by-default checks above: the counting layer's entry
# points have no device.  They run the program once on fake CPU tensors
# (``dist/hlo_cost.py::record``, on a fake process group where a mesh is
# needed), which allocates nothing and runs nothing on any device, so there
# is no card to default to.
COUNTING_ENTRY_POINTS = (("repro_torch.dist.hlo_cost", "record"),
                         ("repro_torch.dist.hlo_cost", "analyze"),
                         ("repro_torch.dist.calibrate", "calibrate"),
                         ("repro_torch.launch.dryrun", "run_one"),
                         ("repro_torch.launch.dryrun", "main"),
                         ("repro_torch.launch.sweep", "main"),
                         ("repro_torch.obs.mfu", "lowered_flops"))


@pytest.mark.parametrize("module,name", COUNTING_ENTRY_POINTS)
def test_counting_entry_points_have_no_device(module, name):
    """None takes a device or a ``--device`` flag; recording a CPU
    tensor's program leaves it alone."""
    import importlib
    import inspect
    fn = getattr(importlib.import_module(module), name)
    assert "device" not in inspect.signature(fn).parameters
    assert '"--device"' not in inspect.getsource(fn)


def test_recording_touches_no_argument():
    from repro_torch.dist.hlo_cost import record
    x = torch.ones(3, 4)
    meta = torch.empty(4, 2, device="meta")
    prog = record(lambda a, b: (a.add_(1) @ b), x, meta)
    assert torch.equal(x, torch.ones(3, 4))
    assert [op.name for op in prog.ops] == ["aten.add_.Tensor",
                                            "aten.mm.default"]


def test_scan_covers_the_training_attention_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"launch/mesh.py", "models/attention.py",
            "core/weighted_agg.py"} <= scanned


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda(no_card, name, monkeypatch, tmp_path,
                                  capsys):
    """Each example's counterpart runs on the card unless given ``--device
    cpu``, and raises here."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def test_meshes_default_to_cuda(no_card, tmp_path):
    """``make_test_mesh`` names CUDA unless asked for the CPU, and raises
    here before it builds anything."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            make_test_mesh((1, 1))
        mesh = make_test_mesh((1, 1), device="cpu")
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == (
            "data", "model")
    finally:
        dist.destroy_process_group()


def test_scan_covers_the_distribution_slice():
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in PORT_FILES[:-1]}
    assert {"dist/__init__.py", "dist/sharding.py",
            "launch/specs.py"} <= scanned


class _StandInMesh:
    """A mesh of names and sizes on the card, as a DeviceMesh built for
    CUDA would be (none can be built here)."""
    mesh_dim_names = ("data", "model")
    shape = (1, 1)
    ndim = 2
    device_type = "cuda"


def test_distribution_defaults_to_cuda(no_card):
    """``make_run_ctx`` names CUDA unless asked for the CPU; ``distribute``
    onto a CUDA mesh and ``concretize`` raise here before they move
    anything; ``init_cache(as_spec=True)`` needs no device at all."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.dist import distribute, make_plan, make_run_ctx
    from repro_torch.launch.specs import concretize, train_batch_specs
    from repro_torch.models import RunCtx, init_cache
    cfg = get_config("qwen2-0.5b").reduced()
    plan = make_plan(_StandInMesh())
    assert make_run_ctx(cfg, plan).device == "cuda"
    assert make_run_ctx(cfg, plan, device="cpu").device == "cpu"
    params = {"embed": torch.zeros((4, 2))}
    with pytest.raises(RuntimeError, match="cuda"):
        distribute(params, {"embed": (None, None)}, _StandInMesh())
    specs = train_batch_specs(cfg, get_shape("train_4k"))
    assert specs["tokens"].device.type == "meta"
    with pytest.raises(RuntimeError, match="cuda"):
        concretize(specs)
    cache = init_cache(cfg, 2, 8, RunCtx(), as_spec=True)
    assert cache["pos"].device.type == "meta"


def test_fused_sgdm_dtensors_never_run_the_plain_version(tmp_path,
                                                        monkeypatch):
    """DTensors whose shards are not on the CPU (meta here, CUDA on the
    card) never reach the plain version: the wrapper unwraps them and the
    device check refuses.  CPU DTensors run it on their local shards, plain
    tensors, and come back with their placements; mixed or unequally
    placed arguments raise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import block_topk as bt
    from repro_torch.launch.mesh import make_test_mesh
    seen = []
    plain = bt.fused_sgdm_ref

    def record(p, m, g, *a):
        seen.append(tuple(type(t).__name__ for t in (p, m, g)))
        return plain(p, m, g, *a)

    monkeypatch.setattr(bt, "fused_sgdm_ref", record)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), device="cpu")
        pl = (Replicate(), Shard(0))

        def dt(t, placements=pl):
            return DTensor.from_local(t, mesh, placements)

        x = torch.zeros((4, 8), device="meta")
        with pytest.raises(ValueError, match="device"):
            bt.fused_sgdm(dt(x), dt(x), dt(x), 0.1)
        assert seen == []
        p, m, g = (torch.randn((4, 8), generator=torch.Generator()
                               .manual_seed(i)) for i in range(3))
        p2, m2 = bt.fused_sgdm(dt(p), dt(m), dt(g), 0.1, 0.9, 0.01)
        assert seen == [("Tensor", "Tensor", "Tensor")]
        assert isinstance(p2, DTensor) and tuple(p2.placements) == pl
        assert tuple(m2.placements) == pl
        want = plain(p, m, g, 0.1, 0.9, 0.01)
        assert torch.equal(p2.to_local(), want[0])
        assert torch.equal(m2.to_local(), want[1])
        with pytest.raises(TypeError, match="all be DTensors"):
            bt.fused_sgdm(dt(p), m, g, 0.1)
        with pytest.raises(ValueError, match="placements"):
            bt.fused_sgdm(dt(p), dt(m), dt(g, (Replicate(), Replicate())),
                          0.1)
    finally:
        dist.destroy_process_group()
